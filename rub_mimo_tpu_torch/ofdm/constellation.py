"""Constellation tables and hard mapping/demapping.

Port of rub_mimo_tpu/ofdm/constellation.py.  The tables are host-side
numpy constants, identical to the JAX package's (the parity tests check
them bitwise); ``modulate`` / ``demodulate`` run in torch on whatever
device the symbols live on.  Soft (LLR) demapping is not ported yet.

Demapping is nearest neighbour over the table, written as the score
argmax_k Re(y) Re(c_k) + Im(y) Im(c_k) - |c_k|^2 / 2 with the first
maximum winning — the same rule the CUDA payload kernel applies.
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch

from rub_mimo_tpu.config import Modulation

_SQRT2 = math.sqrt(2.0)

# Reference BPSK table, mimo/framing.cc:35-39.
BPSK_TABLE = np.array([-1.0 + 0j, 1.0 + 0j], dtype=np.complex64)

# Reference QPSK table with its sqrt(2)-per-axis amplitude,
# mimo/framing.cc:40-46 (used only by the QPSK-S1 preamble variant).
QPSK_REFERENCE_TABLE = np.array(
    [
        _SQRT2 + 1j * _SQRT2,
        -_SQRT2 + 1j * _SQRT2,
        -_SQRT2 - 1j * _SQRT2,
        _SQRT2 - 1j * _SQRT2,
    ],
    dtype=np.complex64,
)


def _gray(n: int) -> int:
    return n ^ (n >> 1)


def _square_qam(bits: int) -> np.ndarray:
    """Gray-coded square QAM with unit average energy (QPSK/16/64/256)."""
    side = 1 << (bits // 2)
    bits_per_axis = bits // 2
    gray_to_level = np.empty(side, dtype=np.int64)
    for lvl in range(side):
        gray_to_level[_gray(lvl)] = lvl
    pts = np.empty(1 << bits, dtype=np.complex128)
    for sym in range(1 << bits):
        i_lvl = gray_to_level[sym >> bits_per_axis]
        q_lvl = gray_to_level[sym & (side - 1)]
        pts[sym] = (2 * i_lvl - side + 1) + 1j * (2 * q_lvl - side + 1)
    pts /= np.sqrt(np.mean(np.abs(pts) ** 2))
    return pts.astype(np.complex64)


def optimal_constellation(n: int = 32) -> np.ndarray:
    """The built-in ARB32OPT layout: the n triangular-lattice points of
    least energy about their own centroid (iterated until stable),
    recentred, unit average energy, in canonical raster order.  Not
    float-identical to liquid-dsp's arb32opt list; install that with
    ``set_arb32opt_table`` for symbol-exact parity with its captures."""
    pts = []
    for a in range(-8, 9):
        for b in range(-8, 9):
            pts.append((a + 0.5 * b) + 1j * (np.sqrt(3) / 2.0) * b)
    pts = np.array(pts, dtype=np.complex128)
    sel = pts[np.argsort(np.abs(pts))[:n]]
    for _ in range(50):
        c = sel.mean()
        new = pts[np.argsort(np.abs(pts - c))[:n]]
        if np.array_equal(np.sort(new.view(float)), np.sort(sel.view(float))):
            break
        sel = new
    sel = sel - sel.mean()
    sel /= np.sqrt(np.mean(np.abs(sel) ** 2))
    order = np.lexsort((np.round(sel.real, 9), np.round(sel.imag, 9)))
    return sel[order].astype(np.complex64)


_ARB32_OVERRIDE: np.ndarray | None = None


def set_arb32opt_table(points) -> None:
    """Install an exact external 32-point table into the ARB32OPT slot
    (e.g. liquid-dsp's published list); None restores the built-in one."""
    global _ARB32_OVERRIDE
    if points is None:
        _ARB32_OVERRIDE = None
    else:
        pts = np.asarray(points, dtype=np.complex64).reshape(-1)
        if pts.shape[0] != 32:
            raise ValueError(f"expected 32 points, got {pts.shape[0]}")
        pts = pts.copy()
        pts.setflags(write=False)
        _ARB32_OVERRIDE = pts
    table.cache_clear()


@functools.lru_cache(maxsize=1)
def _arb32_optimal() -> np.ndarray:
    t = optimal_constellation(32)
    t.setflags(write=False)
    return t


@functools.lru_cache(maxsize=16)
def table(modulation: Modulation) -> np.ndarray:
    """The modulation's constellation points, complex64, read-only."""
    if modulation == Modulation.BPSK:
        t = BPSK_TABLE.copy()
    elif modulation == Modulation.QPSK:
        t = _square_qam(2)
    elif modulation == Modulation.QAM16:
        t = _square_qam(4)
    elif modulation == Modulation.QAM64:
        t = _square_qam(6)
    elif modulation == Modulation.QAM256:
        t = _square_qam(8)
    elif modulation == Modulation.ARB32OPT:
        t = (_ARB32_OVERRIDE.copy() if _ARB32_OVERRIDE is not None
             else _arb32_optimal().copy())
    else:  # pragma: no cover
        raise ValueError(f"unknown modulation {modulation}")
    t.setflags(write=False)
    return t


def demap_planes(points: np.ndarray) -> np.ndarray:
    """[3, K] float32 rows (Re c_k, Im c_k, |c_k|^2 / 2): the demap
    score's constants, rounded as the JAX package rounds them."""
    t = np.asarray(points, dtype=np.complex64)
    return np.stack([t.real, t.imag, np.abs(t) ** 2 / 2.0]).astype(np.float32)


def modulate(symbols: torch.Tensor, modulation: Modulation) -> torch.Tensor:
    """Map integer symbols in [0, arity) to constellation points."""
    t = torch.as_tensor(np.array(table(modulation)), device=symbols.device)
    return t[symbols.long()]


def hard_demap(y: torch.Tensor, points: np.ndarray) -> torch.Tensor:
    """Nearest-neighbour decisions (int32, y's shape) over ``points``:
    argmax_k Re(y) Re(c_k) + Im(y) Im(c_k) - |c_k|^2 / 2, first max wins."""
    c = torch.as_tensor(demap_planes(points), device=y.device)
    yr = y.real.float().unsqueeze(-1)
    yi = y.imag.float().unsqueeze(-1)
    scores = yr * c[0] + yi * c[1] - c[2]
    return torch.argmax(scores, dim=-1).to(torch.int32)


def demodulate(y: torch.Tensor, modulation: Modulation) -> torch.Tensor:
    """Hard-decision demapping for the modulation's table."""
    return hard_demap(y, table(modulation))
