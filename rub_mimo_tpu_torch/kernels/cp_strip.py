"""Per-symbol cyclic-prefix strip (K7).

Port of rub_mimo_tpu/kernels/cp_strip.py::cp_strip.  On CUDA tensors
``cp_strip`` launches the hand-written Hopper kernel csrc/cp_strip.cu (one
block per (frame, row), 16-byte copies where aligned, see the source
note); on CPU tensors it runs ``cp_strip_reference``, the plain
reshape-and-slice that the tests and chip_smoke.py hold the kernel
against (bit for bit: the kernel only copies).  There is no fallback: a
CUDA call that the kernel cannot take, or whose build or launch fails,
raises.
"""

from __future__ import annotations

import ctypes
import functools

import torch


def cp_strip_reference(payload: torch.Tensor, n_sym: int, symbol_len: int,
                       cp_len: int) -> torch.Tensor:
    """``payload[:, :n_sym*symbol_len].reshape(S, n_sym, symbol_len)
    [:, :, cp_len:]``, contiguous (framing.cc:558)."""
    S = payload.shape[0]
    p = payload[:, : n_sym * symbol_len].reshape(S, n_sym, symbol_len)
    return p[:, :, cp_len:].contiguous()


@functools.lru_cache(maxsize=None)
def _kernel_fn():
    from rub_mimo_tpu_torch.kernels import _build

    fn = _build.load("cp_strip").cp_strip
    P, I = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = [P, ctypes.c_longlong, I, I, I, I, I, P, P]
    fn.restype = I
    return fn


def _check(payload: torch.Tensor, n_sym: int, symbol_len: int,
           cp_len: int) -> None:
    if payload.dtype not in (torch.complex64, torch.float32):
        raise ValueError("cp_strip: payload must be complex64 or float32, "
                         f"got {payload.dtype}")
    if payload.dim() != 2 or not 1 <= payload.shape[0] <= 65535:
        raise ValueError("cp_strip: payload must be [S, L] with 1 <= S <= "
                         f"65535, got {tuple(payload.shape)}")
    if not payload.is_contiguous():
        raise ValueError("cp_strip: payload must be contiguous")
    if n_sym < 1 or not 0 <= cp_len < symbol_len:
        raise ValueError("cp_strip: need n_sym >= 1 and 0 <= cp_len < "
                         f"symbol_len, got {n_sym}, {cp_len}, {symbol_len}")
    if payload.shape[1] < n_sym * symbol_len:
        raise ValueError(f"cp_strip: payload holds {payload.shape[1]} "
                         f"samples, fewer than {n_sym} x {symbol_len}")
    if n_sym * symbol_len * 2 >= 1 << 31:
        raise ValueError("cp_strip: payload too long for the kernel")


def cp_strip(payload: torch.Tensor, n_sym: int, symbol_len: int,
             cp_len: int) -> torch.Tensor:
    """CP strip of the flat payload [S, >= n_sym*symbol_len] (complex64
    or float32): returns [S, n_sym, symbol_len - cp_len] in its dtype."""
    if payload.device.type == "cpu":
        return cp_strip_reference(payload, n_sym, symbol_len, cp_len)
    if payload.device.type != "cuda":
        raise ValueError(f"cp_strip: no kernel for {payload.device}")
    _check(payload, n_sym, symbol_len, cp_len)
    S, L = payload.shape
    M = symbol_len - cp_len
    out = torch.empty((S, n_sym, M), dtype=payload.dtype,
                      device=payload.device)
    w = 2 if payload.dtype == torch.complex64 else 1  # 32-bit words
    fn = _kernel_fn()
    with torch.cuda.device(payload.device):
        err = fn(payload.data_ptr(), w * L, S, n_sym, w * symbol_len,
                 w * cp_len, w * M, out.data_ptr(),
                 torch.cuda.current_stream(payload.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"cp_strip kernel launch failed: CUDA error {err}")
    cp_strip.launches += 1
    return out


cp_strip.launches = 0
