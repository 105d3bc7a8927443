"""Max-log-MAP bit LLRs of complex symbols (no TPU counterpart).

The JAX package computes these LLRs in XLA ops
(rub_mimo_tpu/ofdm/constellation.py:222, ``soft_demodulate_llr``), with
no Pallas kernel.  In PyTorch that is some forty passes over [symbols,
points] distance arrays, so on CUDA tensors ``soft_llr`` launches one
hand-written kernel, csrc/soft_llr.cu (one thread a symbol, the points
in the kernel's parameters, see the source note), for every symbol at
once.  On CPU tensors it runs ``soft_llr_plain``, the chunked PyTorch
body that ``constellation.soft_demodulate_llr`` ran before the kernel.
The kernel computes the plain version's values on the card bit for bit
(NaN where it has NaN).  There is no fallback: a CUDA call that the
kernel cannot take, or whose build or launch fails, raises.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

LLR_CHUNK = 1 << 19  # symbols a pass of soft_llr_plain
MAX_BITS = 8         # QAM256


def _f32(x):
    """A Python number rounded to float32, as the JAX package takes it; a
    tensor as it is."""
    return x if isinstance(x, torch.Tensor) else float(np.float32(x))


@functools.lru_cache(maxsize=32)
def _points_on(points: bytes, device: torch.device) -> torch.Tensor:
    return torch.as_tensor(np.frombuffer(points, np.complex64).copy(),
                           device=device)


def _bits_of(points: np.ndarray) -> int:
    """log2 of the point count: 1 to MAX_BITS, or ValueError."""
    k = points.shape[0]
    if points.ndim != 1 or k < 2 or k > 1 << MAX_BITS or k & (k - 1):
        raise ValueError("soft_llr: points must be a 1-D table of 2 to "
                         f"{1 << MAX_BITS} points, a power of two; got "
                         f"{points.shape}")
    return k.bit_length() - 1


def _points(points) -> np.ndarray:
    return np.ascontiguousarray(np.asarray(points, dtype=np.complex64))


def soft_llr_plain(y: torch.Tensor, points,
                   noise_var: float | torch.Tensor = 1.0) -> torch.Tensor:
    """Max-log-MAP bit LLRs [..., bits] float32 of the complex64 symbols
    y over the table ``points`` (2^bits complex64; positive -> bit 0,
    bits MSB-first): per bit, the best metric -|y - c|^2 / noise_var over
    the points whose bit is 0 less the best over those whose bit is 1,
    with the JAX package's |y - c|^2.

    The symbols go through in passes of LLR_CHUNK (the function is
    elementwise per symbol, so this is exact): the [N, points] distances
    of the operating point's 4.1 M symbols at once would take 524 MB.  A
    bit splits the point index as [2^b, 2, 2^(bits-1-b)], so each bit's
    two maxima are reductions over a view."""
    pts = _points(points)
    bits = _bits_of(pts)
    t = _points_on(pts.tobytes(), y.device)
    yf = y.reshape(-1)
    out = torch.empty((yf.shape[0], bits), dtype=torch.float32,
                      device=y.device)
    for c0 in range(0, yf.shape[0], LLR_CHUNK):
        metric = (yf[c0:c0 + LLR_CHUNK, None] - t[None, :]).abs() ** 2
        metric = metric.neg_().div_(_f32(noise_var))
        n = metric.shape[0]
        for b in range(bits):
            v = metric.view(n, 1 << b, 2, 1 << (bits - 1 - b))
            out[c0:c0 + n, b] = (v[:, :, 0].amax(dim=(1, 2))
                                 - v[:, :, 1].amax(dim=(1, 2)))
    return out.reshape(*y.shape, bits)


@functools.lru_cache(maxsize=None)
def _kernel_fn():
    from rub_mimo_tpu_torch.kernels import _build

    fn = _build.load("soft_llr").soft_llr
    P, I = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = [P, ctypes.c_longlong, P, I, ctypes.c_float, P, I, P, P]
    fn.restype = I
    return fn


def _noise_var_arg(noise_var, device: torch.device):
    """(value, device tensor or None, reciprocal) for the kernel, the way
    the plain version's ``div_`` takes noise_var on the card: a number (or
    a CPU scalar tensor) is a host scalar, which PyTorch's CUDA division
    applies as a multiply by its float32 reciprocal; a tensor on the
    card is read there (no host read) and divides."""
    if not isinstance(noise_var, torch.Tensor):
        return _f32(noise_var), None, 1
    if noise_var.numel() != 1:
        raise ValueError("soft_llr: noise_var must be a scalar, got shape "
                         f"{tuple(noise_var.shape)}")
    if noise_var.device.type == "cpu":
        return float(np.float32(noise_var.item())), None, 1
    if noise_var.device != device:
        raise ValueError(f"soft_llr: noise_var on {noise_var.device}, "
                         f"symbols on {device}")
    return 0.0, noise_var.to(torch.float32).reshape(()).contiguous(), 0


def soft_llr(y: torch.Tensor, points,
             noise_var: float | torch.Tensor = 1.0) -> torch.Tensor:
    """``soft_llr_plain``'s LLRs [..., bits] float32: the kernel on a CUDA
    tensor (one launch for every symbol), the plain version on a CPU
    tensor."""
    if y.dtype != torch.complex64:
        raise ValueError(f"soft_llr: y must be complex64, got {y.dtype}")
    pts = _points(points)
    bits = _bits_of(pts)
    if y.device.type == "cpu":
        return soft_llr_plain(y, pts, noise_var)
    if y.device.type != "cuda":
        raise ValueError(f"soft_llr: no kernel for {y.device}")
    value, nv, reciprocal = _noise_var_arg(noise_var, y.device)
    yf = y.reshape(-1)
    n = yf.shape[0]
    out = torch.empty((n, bits), dtype=torch.float32, device=y.device)
    if n == 0:
        return out.reshape(*y.shape, bits)
    if n >= 1 << 38:
        raise ValueError(f"soft_llr: {n} symbols too many for the kernel")
    yf = yf.contiguous()
    fn = _kernel_fn()
    with torch.cuda.device(y.device):
        err = fn(yf.data_ptr(), n, pts.ctypes.data, bits, value,
                 None if nv is None else nv.data_ptr(), reciprocal,
                 out.data_ptr(),
                 torch.cuda.current_stream(y.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"soft_llr kernel launch failed: CUDA error {err}")
    soft_llr.launches += 1
    return out.reshape(*y.shape, bits)


soft_llr.launches = 0
