"""Shared seeded builders for the PyTorch-port parity tests
(tests/test_torch_*.py).

Every input is made with numpy from a seed and handed to both packages:
the JAX package (rub_mimo_tpu, the reference, on the CPU) and the port
(rub_mimo_tpu_torch).  JAX's randomness (the simulator's AWGN) never
reaches the port except as a numpy capture.
"""

from __future__ import annotations

import traceback

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from rub_mimo_tpu.config import ModemConfig, tiny_config
from rub_mimo_tpu_torch import convert

# one thread per test worker: the suite runs under pytest-xdist
torch.set_num_threads(1)

# the two sizes the tier-1 parity tests run at (JAX package configs)
TINY = tiny_config()                              # M=64, bit_exact (per-code)
MID = ModemConfig(pid_max=12, bit_exact=False)    # M=2048, joint timing


def pcfg(jcfg):
    """The port's ModemConfig equal to a JAX package config (the port's
    entry points refuse the JAX one)."""
    return convert.config_from_jax(jcfg)


# their twins in the port's own config type
PTINY = pcfg(TINY)
PMID = pcfg(MID)


def jax_capture(cfg: ModemConfig, *, snr_db=35.0, delay=300, seed=3,
                trailing=2048, tx_data=None, **spec_kw):
    """(capture [S, T] complex64 numpy, tx_data numpy) from the JAX
    package's TX + channel simulator (of ``tx_data`` when given)."""
    from rub_mimo_tpu.io import simulator

    spec = simulator.ChannelSpec(snr_db=snr_db, delay=delay, seed=seed,
                                 trailing=trailing, **spec_kw)
    cap, tx_data, _ = simulator.simulate_capture(cfg, spec, tx_data=tx_data)
    return np.array(cap), np.asarray(tx_data)


def jax_decode(cap: np.ndarray, cfg: ModemConfig, **kw):
    """The JAX decode on the path the port mirrors: the coarse sync the
    TPU dispatch takes (the CPU dispatch would pick the full scan)."""
    import jax.numpy as jnp

    from rub_mimo_tpu.pipeline import rx

    kw.setdefault("sync_impl", "coarse")
    return rx.decode(jnp.asarray(cap), cfg, **kw)


# the integer fields of a DecodeResult: equal in every parity test
INT_FIELDS = ("synced", "sync_index", "sync_sample", "plateau_start",
              "plateau_end", "s0_index", "ac_index", "decode_start",
              "rx_data", "symbol_valid")


def assert_decode_matches_jax(got, ref) -> None:
    """The port's DecodeResult against the JAX one of the same capture:
    integer fields equal; G and W within rtol 1e-4 (estimation rounding);
    cfo_hat and cfo_coarse within 1e-5; the debug outputs kept on both
    sides or on neither, and where kept the metric within 1e-5 where it
    exceeds 0.5 (the plateau rule reads it only near its threshold; noise
    windows are ratios of cancelled sums) and the matched filter's traces
    within 1e-5 of their peak."""
    for f in INT_FIELDS:
        np.testing.assert_array_equal(n(getattr(got, f)),
                                      np.asarray(getattr(ref, f)), err_msg=f)
    for f in ("G", "W"):
        np.testing.assert_allclose(n(getattr(got, f)),
                                   np.asarray(getattr(ref, f)), rtol=1e-4,
                                   atol=1e-6, err_msg=f)
    for f in ("cfo_hat", "cfo_coarse"):
        assert abs(float(getattr(got, f)) - float(getattr(ref, f))) < 1e-5, f
    for f in ("metric", "mf_traces"):
        assert (getattr(got, f) is None) == (getattr(ref, f) is None), f
    if ref.metric is not None:
        m, jm = n(got.metric), np.asarray(ref.metric)
        near = jm > 0.5
        assert m.dtype == np.float32 and near.any()
        np.testing.assert_allclose(m[near], jm[near], rtol=0, atol=1e-5)
    if ref.mf_traces is not None:
        tr, jtr = n(got.mf_traces), np.asarray(ref.mf_traces)
        np.testing.assert_allclose(tr, jtr, rtol=0, atol=1e-5 * jtr.max())


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


class HostReads(TorchDispatchMode):
    """Records each dispatched operator that would read a CUDA tensor
    back to the host (a scalar read, a data-dependent output size) or
    upload host data (a tensor made from a Python or numpy value), with
    the port's frames that called it."""

    NAMES = ("_local_scalar_dense", "lift_fresh", "nonzero",
             "masked_select", "unique", "is_nonzero", "aten.equal",
             "repeat_interleave.Tensor")

    def __init__(self):
        super().__init__()
        self.hits = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        name = str(func)
        read = any(k in name for k in self.NAMES) or (
            name.startswith("aten.index.Tensor")
            and any(isinstance(i, torch.Tensor) and i.dtype == torch.bool
                    for i in args[1] if i is not None))
        if read:
            self.hits.append((name, [
                f"{fr.filename.rsplit('/', 2)[-1]}:{fr.lineno}"
                for fr in traceback.extract_stack()
                if "rub_mimo_tpu_torch" in fr.filename][-3:]))
        return func(*args, **(kwargs or {}))
