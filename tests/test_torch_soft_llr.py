"""The soft-LLR module (rub_mimo_tpu_torch.kernels.soft_llr) on the CPU:
the wrapper takes its plain version there and counts no launch, the
argument checks the kernel relies on, and the algebra the kernel uses on
the card, bit for bit: for 0 < noise_var < inf, the best of -d2 scaled
over a bit half equals -(min d2) scaled once, for the true division the
plain version makes on the CPU and for the multiply by fl(1 / noise_var)
that PyTorch's CUDA division by a host scalar makes.  The kernel itself
runs in tests/test_torch_cuda.py and chip_smoke.py.  No jax here."""

import numpy as np
import pytest
import torch

from rub_mimo_tpu_torch.config import Modulation
from rub_mimo_tpu_torch.kernels import soft_llr as ks
from rub_mimo_tpu_torch.ofdm import constellation

MODS = (Modulation.BPSK, Modulation.QPSK, Modulation.QAM16,
        Modulation.ARB32OPT, Modulation.QAM64, Modulation.QAM256)
NOISE_VARS = (1.0, 0.37, 1e-6)


def symbols(mod: Modulation, n: int = 301) -> torch.Tensor:
    """Seeded symbols around the table, with NaN, +-Inf, huge rows and a
    symbol exactly on a point."""
    tab = constellation.table(mod)
    rng = np.random.default_rng(n + len(tab))
    y = ((rng.standard_normal(n) + 1j * rng.standard_normal(n)) * 0.8
         ).astype(np.complex64)
    y[:9] = [np.nan, np.inf, -np.inf, 1e30, complex(np.inf, np.nan),
             complex(0.0, np.nan), 1e19, complex(-1e30, 1e30), tab[-1]]
    return torch.as_tensor(y)


def same(a: torch.Tensor, b: torch.Tensor) -> bool:
    """Equal values, NaN where the other is NaN."""
    return a.shape == b.shape and bool(
        ((a == b) | (torch.isnan(a) & torch.isnan(b))).all())


def min_then_scale(y: torch.Tensor, tab: np.ndarray, scale) -> torch.Tensor:
    """The kernel's fast path in torch: per bit half the min of |y - c|^2
    (NaN where d2 is NaN), negated and scaled once."""
    bits = len(tab).bit_length() - 1
    d2 = (y[:, None] - torch.as_tensor(tab.copy())[None, :]).abs() ** 2
    out = torch.empty((y.shape[0], bits), dtype=torch.float32)
    for b in range(bits):
        v = d2.view(-1, 1 << b, 2, 1 << (bits - 1 - b))
        lo = v[:, :, 0].amin(dim=(1, 2))
        hi = v[:, :, 1].amin(dim=(1, 2))
        out[:, b] = scale(lo.neg()) - scale(hi.neg())
    return out


@pytest.mark.parametrize("mod", MODS, ids=lambda m: m.name)
def test_soft_llr_on_cpu_is_the_plain_version(mod):
    y = symbols(mod).reshape(7, 43)
    tab = constellation.table(mod)
    before = ks.soft_llr.launches
    for nv in NOISE_VARS + (torch.tensor(0.37),):
        got = ks.soft_llr(y, tab, nv)
        assert got.dtype == torch.float32
        assert got.shape == (7, 43, mod.bits_per_symbol)
        assert same(got, ks.soft_llr_plain(y, tab, nv))
    assert same(constellation.soft_demodulate_llr(y, mod, 0.37),
                ks.soft_llr_plain(y, tab, 0.37))
    assert ks.soft_llr.launches == before


@pytest.mark.parametrize("nv", NOISE_VARS)
@pytest.mark.parametrize("mod", MODS, ids=lambda m: m.name)
def test_min_then_scale_equals_the_plain_version(mod, nv):
    """The identity the kernel's fast path relies on, on both scalings:
    a true division (the plain version as it runs here) and a multiply by
    the float32 reciprocal (the plain version's scaling on the card)."""
    y, tab = symbols(mod), constellation.table(mod)
    nv32 = float(np.float32(nv))
    assert same(ks.soft_llr_plain(y, tab, nv),
                min_then_scale(y, tab, lambda x: x.div(nv32)))
    inv = float(np.float32(1.0) / np.float32(nv32))
    bits = mod.bits_per_symbol
    metric = ((y[:, None] - torch.as_tensor(tab.copy())[None, :]).abs() ** 2
              ).neg_().mul_(inv)
    by_reciprocal = torch.stack([
        metric.view(-1, 1 << b, 2, 1 << (bits - 1 - b))[:, :, 0].amax(
            dim=(1, 2))
        - metric.view(-1, 1 << b, 2, 1 << (bits - 1 - b))[:, :, 1].amax(
            dim=(1, 2)) for b in range(bits)], dim=-1)
    assert same(by_reciprocal, min_then_scale(y, tab, lambda x: x.mul(inv)))


def test_soft_llr_rejects_what_the_kernel_cannot_take():
    y = symbols(Modulation.QPSK, 16)
    tab = constellation.table(Modulation.QPSK)
    with pytest.raises(ValueError):
        ks.soft_llr(y.to(torch.complex128), tab)
    with pytest.raises(ValueError):
        ks.soft_llr(y.real.contiguous(), tab)
    for bad in (np.zeros(512, np.complex64), np.zeros(3, np.complex64),
                np.zeros(1, np.complex64), np.zeros((2, 2), np.complex64)):
        with pytest.raises(ValueError):
            ks.soft_llr(y, bad)
    with pytest.raises(ValueError):
        ks.soft_llr(y.to("meta"), tab)
