"""The plan, the twiddles and the parameter struct of the fused payload
tails K1 and K2 (rub_mimo_tpu_torch/kernels/payload_fused.py and
csrc/payload_fft.cuh), on the CPU.

The kernels run their FFT as Stockham passes of ``fft_plan(M)`` with the
twiddles of ``pass_twiddles(M)`` and take the demap points packed by
``pack_points``.  Here ``stockham_fft``, the plain PyTorch version of those
passes (same index maps, same twiddle values), is held against
``torch.fft.fft`` and the JAX package's FFT for every M the kernels take
and 1-4 streams, and the packing against ``constellation.demap_planes`` and
the constants the JAX Pallas kernel bakes in.  The CUDA kernels themselves
are held against their plain versions in test_torch_cuda.py, which needs a
GPU.

    python -m pytest tests/test_torch_fft_plan.py -q
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from rub_mimo_tpu.config import Modulation as JModulation
from rub_mimo_tpu.ofdm import constellation as jconst
from rub_mimo_tpu_torch import Modulation
from rub_mimo_tpu_torch.kernels import payload_fused as pf
from rub_mimo_tpu_torch.ofdm import constellation
import torch_oracle  # noqa: F401  (one torch thread per worker)

GATE_M = [1 << m for m in range(6, 13)]  # every M of strip_supported
FFT_RTOL = 1e-5  # of the output's RMS: float32 passes vs a library FFT


def _signal(S: int, M: int, n_sym: int = 3) -> np.ndarray:
    rng = np.random.default_rng(M + S)
    return (rng.standard_normal((S, n_sym, M))
            + 1j * rng.standard_normal((S, n_sym, M))).astype(np.complex64)


@pytest.mark.parametrize("M", GATE_M)
def test_fft_plan_multiplies_to_M(M):
    plan = pf.fft_plan(M)
    assert int(np.prod(plan)) == M
    assert plan[0] == 16 and set(plan) <= {2, 4, 8, 16}
    # radix 16 while four radix-2 stages are left, the rest last
    assert len(plan) == -(-(M.bit_length() - 1) // 4)
    assert all(r == 16 for r in plan[:-1])
    assert pf.strip_supported(M, 2, 32)


def test_fft_plan_refuses_what_is_not_a_power_of_two():
    for M in (8, 96, 1000):
        with pytest.raises(ValueError):
            pf.fft_plan(M)


@pytest.mark.parametrize("M", GATE_M)
def test_pass_twiddles_are_the_table_gathered(M):
    table = pf.twiddle_table(M)
    exact = np.exp(-2j * np.pi * np.arange(M) / M)
    assert table.dtype == np.complex64
    # float64-built, rounded once: within a float32 rounding of the value
    assert np.abs(table - exact).max() <= 2 ** -23
    tw = pf.pass_twiddles(M)
    plan = pf.fft_plan(M)
    off, Ns = 0, plan[0]
    for R in plan[1:]:
        block = tw[off:off + R * Ns].reshape(R, Ns)
        r, k = np.arange(R)[:, None], np.arange(Ns)[None, :]
        np.testing.assert_array_equal(block, table[r * k * (M // (Ns * R))])
        off, Ns = off + R * Ns, Ns * R
    assert off == len(tw)


@pytest.mark.parametrize("S", [1, 2, 3, 4])
@pytest.mark.parametrize("M", GATE_M)
def test_stockham_passes_match_torch_fft(M, S):
    x = torch.as_tensor(_signal(S, M))
    got = pf.stockham_fft(x)
    ref = torch.fft.fft(x, dim=-1)
    assert got.dtype == torch.complex64 and got.shape == ref.shape
    rms = float(torch.sqrt(torch.mean(ref.abs() ** 2)))
    assert float((got - ref).abs().max()) <= FFT_RTOL * rms


@pytest.mark.parametrize("M", [64, 512, 2048, 4096])
def test_stockham_passes_match_the_jax_fft(M):
    x = _signal(2, M)
    got = pf.stockham_fft(torch.as_tensor(x)).numpy()
    ref = np.asarray(jnp.fft.fft(jnp.asarray(x), axis=-1))
    rms = float(np.sqrt(np.mean(np.abs(ref) ** 2)))
    assert float(np.abs(got - ref).max()) <= FFT_RTOL * rms


SMALL_TABLES = ["BPSK", "QPSK", "QAM16", "ARB32OPT", "QAM64"]


@pytest.mark.parametrize("mod", SMALL_TABLES)
def test_pack_points_matches_demap_planes(mod):
    table = constellation.table(Modulation[mod])
    packed = pf.pack_points(table)
    K = len(table)
    assert packed.dtype == np.float32 and packed.shape == (3, pf.MAX_POINTS)
    assert packed.nbytes == 768  # the kernels' Points struct, by value
    np.testing.assert_array_equal(packed[:, :K],
                                  constellation.demap_planes(table))
    assert not packed[:, K:].any()


@pytest.mark.parametrize("mod", SMALL_TABLES)
def test_pack_points_matches_the_jax_kernels_constants(mod):
    """The JAX Pallas kernel bakes in cr = Re c, ci = Im c and
    cb = |c|^2 / 2 as float32 constants, in table order."""
    t = np.asarray(jconst.table(JModulation[mod]))
    cr = [np.float32(v) for v in t.real]
    ci = [np.float32(v) for v in t.imag]
    cb = [np.float32(v) for v in (np.abs(t) ** 2 / 2.0)]
    packed = pf.pack_points(constellation.table(Modulation[mod]))
    np.testing.assert_array_equal(packed[:, :len(t)],
                                  np.array([cr, ci, cb], np.float32))


def test_pack_points_refuses_more_than_64():
    with pytest.raises(ValueError, match="at most 64"):
        pf.pack_points(constellation.table(Modulation.QAM256))
    assert not pf.strip_supported(2048, 2, 65)
