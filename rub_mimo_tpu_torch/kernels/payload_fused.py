"""Strip-fused payload tail: CP strip + FFT + ZF/MMSE equalize + hard demap.

Port of rub_mimo_tpu/kernels/payload_fused.py::payload_fused_strip.  On
CUDA tensors ``payload_fused_strip`` launches the hand-written Hopper
kernel csrc/payload_fused_strip.cu (one block per frame, radix-2 FFT in
shared memory, see the source note); on CPU tensors it runs
``payload_tail_reference``, the plain PyTorch version of the same math
that the tests and chip_smoke.py hold the kernel against.  There is no
fallback: a CUDA call that the kernel cannot take, or whose build or
launch fails, raises.

Outputs are [S, n_sym, M] in natural subcarrier order with exactly n_sym
frames; the JAX kernel's packed order and pad frames were TPU tile
artifacts.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from rub_mimo_tpu_torch.detect import zf
from rub_mimo_tpu_torch.ofdm import constellation

MAX_POINTS = 64


def strip_supported(M: int, n_streams: int, arity: int) -> bool:
    """Geometry gate of the CUDA kernel: M a power of two in [64, 4096],
    1..4 streams, at most 64 points.  The kernel equalizes and demaps
    every subcarrier, so the caller's allocation must be all-occupied."""
    return (64 <= M <= 4096 and M & (M - 1) == 0
            and 1 <= n_streams <= 4 and arity <= MAX_POINTS)


def payload_tail_reference(p_re: torch.Tensor, p_im: torch.Tensor,
                           W: torch.Tensor, gain: torch.Tensor,
                           table: np.ndarray, dft_norm: float, *,
                           n_sym: int, symbol_len: int, cp_len: int,
                           emit_sig: bool = True):
    """Plain PyTorch payload tail: reshape-strip the CPs, torch.fft.fft,
    scale by dft_norm, detect.zf.equalize, hard demap over ``table``.
    Same arguments and results as ``payload_fused_strip``."""
    S = p_re.shape[0]
    x = torch.complex(p_re, p_im)[:, : n_sym * symbol_len]
    x = x.reshape(S, n_sym, symbol_len)[:, :, cp_len:]
    X = torch.fft.fft(x, dim=-1) * float(dft_norm)
    eq = zf.equalize(X.transpose(0, 1), W, gain).transpose(0, 1)
    rx_data = constellation.hard_demap(eq, table)
    return (eq.contiguous() if emit_sig else None), rx_data


@functools.lru_cache(maxsize=None)
def _kernel_fn():
    from rub_mimo_tpu_torch.kernels import _build

    fn = _build.load("payload_fused_strip").payload_fused_strip
    P, I = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = [P, P, ctypes.c_longlong, P, P, P, I, P, ctypes.c_float,
                   I, I, I, I, I, I, P, P, P]
    fn.restype = I
    return fn


@functools.lru_cache(maxsize=16)
def _points(table_bytes: bytes, device: torch.device) -> torch.Tensor:
    """The demap constants [3, K] on the device, cached per table (a host
    to device copy per call would synchronize the stream)."""
    t = np.frombuffer(table_bytes, dtype=np.complex64)
    return torch.as_tensor(constellation.demap_planes(t), device=device)


@functools.lru_cache(maxsize=8)
def _twiddles(M: int, device: torch.device) -> torch.Tensor:
    """exp(-2 pi i j / M), j < M/2: float64, rounded once to complex64."""
    tw = np.exp(-2j * np.pi * np.arange(M // 2) / M).astype(np.complex64)
    return torch.as_tensor(tw, device=device)


def _check(p_re, p_im, W, gain, table, n_sym, symbol_len, cp_len):
    S = p_re.shape[0]
    M = symbol_len - cp_len
    for name, t, dt, shape in (
        ("p_re", p_re, torch.float32, (S, n_sym * symbol_len)),
        ("p_im", p_im, torch.float32, (S, n_sym * symbol_len)),
        ("W", W, torch.complex64, (M, S, S)),
        ("gain", gain, torch.float32, (M,)),
    ):
        if t.dtype != dt:
            raise ValueError(f"{name} must be {dt}, got {t.dtype}")
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} must have shape {shape}, "
                             f"got {tuple(t.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if n_sym < 1 or cp_len < 0:
        raise ValueError("need n_sym >= 1 and cp_len >= 0")
    if not strip_supported(M, S, len(table)):
        raise ValueError(
            f"payload_fused_strip kernel does not take M={M}, S={S}, "
            f"{len(table)} points (see strip_supported)")


def payload_fused_strip(p_re: torch.Tensor, p_im: torch.Tensor,
                        W: torch.Tensor, gain: torch.Tensor,
                        table: np.ndarray, dft_norm: float, *,
                        n_sym: int, symbol_len: int, cp_len: int,
                        emit_sig: bool = True):
    """Payload tail over the flat payload planes.

    p_re, p_im: [S, n_sym*symbol_len] float32, CPs in place (what
    pipeline.rx.extract_payload gives); W: [M, out, rx] complex64;
    gain: [M] float32; table: constellation points (numpy);
    dft_norm: 1/sqrt(M_occupied).

    Returns (rx_sig [S, n_sym, M] complex64 | None, rx_data [S, n_sym, M]
    int32), natural order, with
    eq[o, k, sc] = (sum_j W[sc, o, j] X[j, k, sc]) * gain[sc],
    X = DFT_M(strip(x)) * dft_norm, demapped nearest-neighbour."""
    devices = {t.device for t in (p_re, p_im, W, gain)}
    if len(devices) != 1:
        raise ValueError("payload_fused_strip: inputs on several devices "
                         f"{sorted(map(str, devices))}")
    if p_re.device.type == "cpu":
        return payload_tail_reference(
            p_re, p_im, W, gain, table, dft_norm, n_sym=n_sym,
            symbol_len=symbol_len, cp_len=cp_len, emit_sig=emit_sig)
    if p_re.device.type != "cuda":
        raise ValueError(f"payload_fused_strip: no kernel for {p_re.device}")
    _check(p_re, p_im, W, gain, table, n_sym, symbol_len, cp_len)
    dev = p_re.device
    S = p_re.shape[0]
    M = symbol_len - cp_len
    fn = _kernel_fn()
    points = _points(np.asarray(table, np.complex64).tobytes(), dev)
    twiddle = _twiddles(M, dev)
    rx_data = torch.empty((S, n_sym, M), dtype=torch.int32, device=dev)
    rx_sig = (torch.empty((S, n_sym, M), dtype=torch.complex64, device=dev)
              if emit_sig else None)
    with torch.cuda.device(dev):
        err = fn(p_re.data_ptr(), p_im.data_ptr(), p_re.shape[1],
                 W.data_ptr(), gain.data_ptr(), points.data_ptr(),
                 points.shape[1], twiddle.data_ptr(), float(dft_norm),
                 S, M, M.bit_length() - 1, n_sym, symbol_len, cp_len,
                 rx_data.data_ptr(),
                 None if rx_sig is None else rx_sig.data_ptr(),
                 torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(
            f"payload_fused_strip kernel launch failed: CUDA error {err}")
    payload_fused_strip.launches += 1
    return rx_sig, rx_data


payload_fused_strip.launches = 0
