"""Shared seeded builders for the PyTorch-port parity tests
(tests/test_torch_*.py).

Every input is made with numpy from a seed and handed to both packages:
the JAX package (rub_mimo_tpu, the reference, on the CPU) and the port
(rub_mimo_tpu_torch).  JAX's randomness (the simulator's AWGN) never
reaches the port except as a numpy capture.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from rub_mimo_tpu.config import ModemConfig, tiny_config

# one thread per test worker: the suite runs under pytest-xdist
torch.set_num_threads(1)

# the two sizes the tier-1 parity tests run at
TINY = tiny_config()                              # M=64, bit_exact (per-code)
MID = ModemConfig(pid_max=12, bit_exact=False)    # M=2048, joint timing


def jax_capture(cfg: ModemConfig, *, snr_db=35.0, delay=300, seed=3,
                trailing=2048, **spec_kw):
    """(capture [S, T] complex64 numpy, tx_data numpy) from the JAX
    package's TX + channel simulator."""
    from rub_mimo_tpu.io import simulator

    spec = simulator.ChannelSpec(snr_db=snr_db, delay=delay, seed=seed,
                                 trailing=trailing, **spec_kw)
    cap, tx_data, _ = simulator.simulate_capture(cfg, spec)
    return np.array(cap), np.asarray(tx_data)


def jax_decode(cap: np.ndarray, cfg: ModemConfig, **kw):
    """The JAX decode on the path the port mirrors: the coarse sync the
    TPU dispatch takes (the CPU dispatch would pick the full scan)."""
    import jax.numpy as jnp

    from rub_mimo_tpu.pipeline import rx

    kw.setdefault("sync_impl", "coarse")
    return rx.decode(jnp.asarray(cap), cfg, **kw)


def jax_state(result) -> dict:
    """The per-capture channel state of a JAX DecodeResult, as numpy,
    in the keys convert.from_jax_state takes."""
    return {k: np.asarray(getattr(result, k)) for k in
            ("G", "W", "normalize_gain", "ac_index", "decode_start")}


def t(a) -> torch.Tensor:
    """numpy (or jax) array -> CPU tensor (a copy)."""
    return torch.as_tensor(np.array(a))


def n(x: torch.Tensor) -> np.ndarray:
    return x.detach().cpu().numpy()


def random_tail_inputs(seed: int, S: int, M: int, cp: int, n_sym: int):
    """Seeded flat payload planes [S, n_sym*(M+cp)] f32 (x2) and a
    well-conditioned channel G [M, S, S] complex64 (numpy)."""
    rng = np.random.default_rng(seed)
    p = rng.standard_normal((2, S, n_sym * (M + cp))).astype(np.float32)
    G = ((rng.standard_normal((M, S, S))
          + 1j * rng.standard_normal((M, S, S))) / np.sqrt(2)
         + 2.0 * np.eye(S)).astype(np.complex64)
    return p[0], p[1], G


def require_cuda() -> torch.device:
    """Skip the calling test unless a CUDA device is present (decided
    inside the test, never at import: every xdist worker must collect
    the same tests)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is "
                    "false)")
    return torch.device("cuda")
