"""Constellation tables and hard mapping/demapping.

Port of rub_mimo_tpu/ofdm/constellation.py.  The tables are host-side
numpy constants, identical to the JAX package's (the parity tests check
them bitwise); ``modulate`` / ``demodulate`` / ``soft_demodulate_llr``
run in torch on whatever device the symbols live on.

Demapping is nearest neighbour over the table, written as the score
argmax_k Re(y) Re(c_k) + Im(y) Im(c_k) - |c_k|^2 / 2 with the first
maximum winning — the same rule the CUDA payload kernels apply.
``hard_demap`` is the plain PyTorch version; ``demodulate`` sends CUDA
tensors to the hard-demap kernel (kernels.eq_demap.demap, K4).
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch

from rub_mimo_tpu_torch.config import Modulation
from rub_mimo_tpu_torch.kernels import soft_llr
# soft_llr_plain's pass length; _f32 rounds a number as the JAX package does
from rub_mimo_tpu_torch.kernels.soft_llr import LLR_CHUNK, _f32  # noqa: F401
from rub_mimo_tpu_torch.utils.device_cache import device_constant

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


def load_arb32opt_table(path) -> np.ndarray:
    """Read a 32-point table from .npy (complex, or [32, 2] float),
    .json ([[re, im], ...]) or text (two floats a line), install it with
    set_arb32opt_table and return the points (complex64)."""
    import json
    from pathlib import Path

    path = Path(path)
    if path.suffix == ".npy":
        arr = np.load(path)
    elif path.suffix == ".json":
        arr = np.asarray(json.loads(path.read_text()), dtype=np.float64)
    else:
        arr = np.loadtxt(path, dtype=np.float64)
    arr = np.asarray(arr)
    if np.iscomplexobj(arr):
        pts = arr.astype(np.complex64).reshape(-1)
    else:
        arr = arr.reshape(-1, 2)
        pts = (arr[:, 0] + 1j * arr[:, 1]).astype(np.complex64)
    set_arb32opt_table(pts)
    return pts


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


@device_constant
def _points_on(points: bytes, device: torch.device) -> torch.Tensor:
    return torch.as_tensor(np.frombuffer(points, np.complex64).copy(),
                           device=device)


def table_on(modulation: Modulation, device: torch.device) -> torch.Tensor:
    """``table(modulation)`` as a complex64 tensor on ``device``, made once
    per table and device (an installed ARB32OPT table gets its own): a
    decode uploads nothing from the host."""
    return _points_on(table(modulation).tobytes(), torch.device(device))


def modulate(symbols: torch.Tensor, modulation: Modulation) -> torch.Tensor:
    """Map integer symbols in [0, arity) to constellation points."""
    return table_on(modulation, symbols.device)[symbols.long()]


@functools.lru_cache(maxsize=32)
def _planes_on(points: bytes, device: torch.device) -> torch.Tensor:
    return torch.as_tensor(demap_planes(np.frombuffer(points, np.complex64)),
                           device=device)


def hard_demap(y: torch.Tensor, points: np.ndarray) -> torch.Tensor:
    """Nearest-neighbour decisions (int32, y's shape) over ``points``:
    argmax_k Re(y) Re(c_k) + Im(y) Im(c_k) - |c_k|^2 / 2, first max wins."""
    c = _planes_on(np.asarray(points, np.complex64).tobytes(), y.device)
    yr = y.real.float().unsqueeze(-1)
    yi = y.imag.float().unsqueeze(-1)
    scores = yr * c[0] + yi * c[1] - c[2]
    return torch.argmax(scores, dim=-1).to(torch.int32)


def demodulate(y: torch.Tensor, modulation: Modulation) -> torch.Tensor:
    """Hard-decision demapping for the modulation's table: on a CUDA
    tensor the K4 kernel (kernels.eq_demap.demap), else hard_demap."""
    if y.device.type == "cuda":
        # imported here: the kernels import this module
        from rub_mimo_tpu_torch.kernels import eq_demap

        return eq_demap.demap(y.to(torch.complex64).contiguous(),
                              table(modulation))
    return hard_demap(y, table(modulation))


def soft_demodulate_llr(y: torch.Tensor, modulation: Modulation,
                        noise_var: float | torch.Tensor = 1.0
                        ) -> torch.Tensor:
    """Max-log-MAP bit LLRs [..., bits_per_symbol] float32 of the
    complex64 symbols y (positive -> bit 0, bits MSB-first): per bit, the
    best metric -|y - c|^2 / noise_var over the points whose bit is 0
    less the best over those whose bit is 1, with the JAX package's
    |y - c|^2.  On a CUDA tensor one launch of the soft-LLR kernel
    (kernels.soft_llr, the rows kernel with the identity geometry), else
    its plain version in passes of LLR_CHUNK symbols."""
    return soft_llr.soft_llr(y, table(modulation), noise_var)
