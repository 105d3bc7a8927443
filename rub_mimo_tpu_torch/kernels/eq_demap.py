"""Equalize + hard demap (K3) and hard demap alone (K4).

Port of rub_mimo_tpu/kernels/eq_demap.py::eq_demap and ::demap.  On CUDA
tensors each wrapper launches its hand-written Hopper kernel in
csrc/eq_demap.cu (one thread per symbol, the points in shared memory,
see the source note); on CPU tensors it runs its plain version:

  eq_demap  ``eq_demap_reference``: detect.zf.equalize, then
            ofdm.constellation.hard_demap;
  demap     ofdm.constellation.hard_demap.

There is no fallback: a CUDA call that a kernel cannot take, or whose
build or launch fails, raises.  ``demap`` is the hard demap of the
decode's generic payload tail on the card: ofdm.constellation.demodulate
routes CUDA tensors here.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from rub_mimo_tpu_torch.detect import zf
from rub_mimo_tpu_torch.kernels.payload_fused import device_points
from rub_mimo_tpu_torch.ofdm import constellation

MAX_EQ_POINTS = 64
MAX_DEMAP_POINTS = 256


def supported(n_streams: int, arity: int) -> bool:
    """Geometry gate of the K3 kernel: 1..4 streams, at most 64 points
    (any number of subcarriers)."""
    return 1 <= n_streams <= 4 and arity <= MAX_EQ_POINTS


def eq_demap_reference(X: torch.Tensor, W: torch.Tensor, gain: torch.Tensor,
                       table: np.ndarray, emit_sig: bool = True):
    """Plain PyTorch equalize + demap, the arguments and results of
    ``eq_demap``."""
    eq = zf.equalize(X.transpose(0, 1), W, gain).transpose(0, 1)
    data = constellation.hard_demap(eq, table)
    return (eq.contiguous() if emit_sig else None), data


@functools.lru_cache(maxsize=None)
def _lib():
    from rub_mimo_tpu_torch.kernels import _build

    lib = _build.load("eq_demap")
    P, I = ctypes.c_void_p, ctypes.c_int
    lib.hard_demap.argtypes = [P, ctypes.c_longlong, P, I, P, P]
    lib.hard_demap.restype = I
    lib.eq_demap.argtypes = [P, P, P, P, I, I, I, I, P, P, P]
    lib.eq_demap.restype = I
    return lib


def _check_eq(X, W, gain, table) -> None:
    if X.dim() != 3:
        raise ValueError(f"eq_demap: X must be [S, n_sym, M], got "
                         f"{tuple(X.shape)}")
    S, n_sym, M = X.shape
    for name, t, dt, shape in (
        ("X", X, torch.complex64, (S, n_sym, M)),
        ("W", W, torch.complex64, (M, S, S)),
        ("gain", gain, torch.float32, (M,)),
    ):
        if t.dtype != dt:
            raise ValueError(f"eq_demap: {name} must be {dt}, got {t.dtype}")
        if tuple(t.shape) != shape:
            raise ValueError(f"eq_demap: {name} must have shape {shape}, "
                             f"got {tuple(t.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"eq_demap: {name} must be contiguous")
    if n_sym < 1 or M < 1 or not supported(S, len(table)):
        raise ValueError(f"eq_demap kernel does not take S={S}, "
                         f"n_sym={n_sym}, M={M}, {len(table)} points")


def eq_demap(X: torch.Tensor, W: torch.Tensor, gain: torch.Tensor,
             table: np.ndarray, emit_sig: bool = True):
    """X: [S(rx), n_sym, M] complex64 frequency-domain payload, already
    scaled by the DFT normalizer; W: [M, out, rx] complex64; gain: [M]
    float32; table: constellation points (numpy).

    Returns (rx_sig [S, n_sym, M] complex64 | None, rx_data [S, n_sym, M]
    int32) with eq[o, k, sc] = (sum_j W[sc, o, j] X[j, k, sc]) * gain[sc],
    demapped nearest-neighbour."""
    devices = {t.device for t in (X, W, gain)}
    if len(devices) != 1:
        raise ValueError("eq_demap: inputs on several devices "
                         f"{sorted(map(str, devices))}")
    if X.device.type == "cpu":
        return eq_demap_reference(X, W, gain, table, emit_sig)
    if X.device.type != "cuda":
        raise ValueError(f"eq_demap: no kernel for {X.device}")
    _check_eq(X, W, gain, table)
    S, n_sym, M = X.shape
    dev = X.device
    pts = device_points(table, dev)
    rx_data = torch.empty((S, n_sym, M), dtype=torch.int32, device=dev)
    rx_sig = (torch.empty((S, n_sym, M), dtype=torch.complex64, device=dev)
              if emit_sig else None)
    with torch.cuda.device(dev):
        err = _lib().eq_demap(
            X.data_ptr(), W.data_ptr(), gain.data_ptr(), pts.data_ptr(),
            pts.shape[1], S, M, n_sym, rx_data.data_ptr(),
            None if rx_sig is None else rx_sig.data_ptr(),
            torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"eq_demap kernel launch failed: CUDA error {err}")
    eq_demap.launches += 1
    return rx_sig, rx_data


eq_demap.launches = 0


def demap(y: torch.Tensor, table: np.ndarray) -> torch.Tensor:
    """Nearest-neighbour decisions (int32, y's shape) of complex64 symbols
    y over ``table`` (at most 256 points): argmax_k Re(y) Re(c_k) +
    Im(y) Im(c_k) - |c_k|^2 / 2, the first maximum winning."""
    if y.device.type == "cpu":
        return constellation.hard_demap(y, table)
    if y.device.type != "cuda":
        raise ValueError(f"demap: no kernel for {y.device}")
    if y.dtype != torch.complex64:
        raise ValueError(f"demap: y must be complex64, got {y.dtype}")
    if not y.is_contiguous():
        raise ValueError("demap: y must be contiguous")
    if y.numel() < 1:
        raise ValueError("demap: y is empty")
    if not 1 <= len(table) <= MAX_DEMAP_POINTS:
        raise ValueError(f"demap kernel does not take {len(table)} points "
                         f"(at most {MAX_DEMAP_POINTS})")
    pts = device_points(table, y.device)
    out = torch.empty(y.shape, dtype=torch.int32, device=y.device)
    with torch.cuda.device(y.device):
        err = _lib().hard_demap(
            y.data_ptr(), y.numel(), pts.data_ptr(), pts.shape[1],
            out.data_ptr(), torch.cuda.current_stream(y.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"demap kernel launch failed: CUDA error {err}")
    demap.launches += 1
    return out


demap.launches = 0
