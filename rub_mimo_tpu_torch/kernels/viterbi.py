"""Soft-decision Viterbi add-compare-select and traceback (no TPU
counterpart).

The JAX package runs the recursion as two lax.scans
(rub_mimo_tpu/ofdm/fec.py:141, ``_viterbi_pairs``), one over the steps
and one back over the stored decisions.  Eagerly that is a Python
iteration of several launches per step, so on CUDA tensors ``viterbi``
launches one hand-written kernel, csrc/viterbi.cu (8 lanes a row, see
the source note), for the whole batch of rows.  On CPU tensors it runs
``viterbi_plain``, the same recursion as a Python loop over the steps on
batched tensors.  The two give the same bits: every float operation of
the recursion is one correctly rounded add or an exact product.  There is
no fallback: a CUDA call that the kernel cannot take, or whose build or
launch fails, raises.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from rub_mimo_tpu_torch.utils.device_cache import device_constant

N_STATES = 64
K = 7
POLYS = (0o171, 0o133)  # generator polynomials, MSB = current input


def _parity(x: np.ndarray) -> np.ndarray:
    p = np.zeros_like(x)
    while np.any(x):
        p ^= x & 1
        x >>= 1
    return p


@functools.lru_cache(maxsize=None)
def trellis():
    """(out_bits [N_STATES, 2, 2], next_state [N_STATES, 2]) int32: the
    register (u << (K-1)) | s, new bit at the MSB; next_state[s, u] =
    (s >> 1) | (u << (K-2)), out_bits[s, u] = parity(register & poly)."""
    s = np.arange(N_STATES)[:, None]
    u = np.arange(2)[None, :]
    reg = (u << (K - 1)) | s
    outs = np.stack([_parity(reg & g) for g in POLYS], axis=-1)
    nxt = (s >> 1) | (u << (K - 2))
    return outs.astype(np.int32), nxt.astype(np.int32)


@device_constant
def _acs_tables(device: torch.device):
    """(sign0, sign1 [64, 2] float32 of +-0.5, pred0, pred1 [64] int64):
    new state s comes from pred0 = (s << 1) & 63 or pred1 = pred0 | 1 on
    input s >> 5, the branch metric sign @ (l0, l1)."""
    outs, _ = trellis()
    sp = np.arange(N_STATES)
    p0 = (sp << 1) & (N_STATES - 1)
    p1 = p0 | 1
    u = sp >> (K - 2)
    s0 = ((1.0 - 2.0 * outs[p0, u]) * 0.5).astype(np.float32)
    s1 = ((1.0 - 2.0 * outs[p1, u]) * 0.5).astype(np.float32)
    return tuple(torch.as_tensor(a, device=device) for a in (s0, s1, p0, p1))


def _check(pairs: torch.Tensor, pinned: torch.Tensor) -> None:
    if (pairs.dtype != torch.float32 or pairs.dim() != 3
            or pairs.shape[-1] != 2):
        raise ValueError("viterbi: pairs must be [rows, T, 2] float32, got "
                         f"{tuple(pairs.shape)} {pairs.dtype}")
    if pinned.dtype != torch.bool or tuple(pinned.shape) != pairs.shape[:1]:
        raise ValueError("viterbi: pinned must be a [rows] bool tensor")
    if pinned.device != pairs.device:
        raise ValueError("viterbi: pairs and pinned on different devices")
    if pairs.shape[0] < 1 or pairs.shape[1] < 1:
        raise ValueError("viterbi: needs at least one row and one step")


def viterbi_plain(pairs: torch.Tensor, pinned: torch.Tensor) -> torch.Tensor:
    """The recursion as a Python loop over the steps (JAX's
    ``_viterbi_pairs`` on every row at once).  pairs: [rows, T, 2]
    float32 LLR pairs; pinned: [rows] bool, True for a row with start and
    end state 0, False for a uniform prior and a traceback from the first
    best state.  Returns the decoded bits [rows, T] int32."""
    _check(pairs, pinned)
    R, T, _ = pairs.shape
    dev = pairs.device
    s0, s1, p0, p1 = _acs_tables(dev)
    pm = torch.zeros((R, N_STATES), dtype=torch.float32, device=dev)
    pm[:, 1:] = torch.where(pinned[:, None], -1e30, 0.0)
    took = torch.empty((T, R, N_STATES), dtype=torch.bool, device=dev)
    for t in range(T):
        l0, l1 = pairs[:, t, 0:1], pairs[:, t, 1:2]
        cand0 = pm[:, p0] + (s0[:, 0] * l0 + s0[:, 1] * l1)
        cand1 = pm[:, p1] + (s1[:, 0] * l0 + s1[:, 1] * l1)
        take1 = cand1 > cand0
        pm = torch.where(take1, cand1, cand0)
        pm = pm - pm.max(dim=1, keepdim=True).values
        took[t] = take1
    state = torch.where(pinned, 0, torch.argmax(pm, dim=1))
    bits = torch.empty((R, T), dtype=torch.int32, device=dev)
    for t in range(T - 1, -1, -1):
        bits[:, t] = state >> (K - 2)
        took1 = took[t].gather(1, state[:, None])[:, 0]
        state = ((state << 1) & (N_STATES - 1)) | took1.long()
    return bits


@functools.lru_cache(maxsize=None)
def _kernel_fn():
    from rub_mimo_tpu_torch.kernels import _build

    fn = _build.load("viterbi").viterbi
    P, I = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = [P, P, I, I, P, P, P]
    fn.restype = I
    return fn


def viterbi(pairs: torch.Tensor, pinned: torch.Tensor) -> torch.Tensor:
    """Decoded bits [rows, T] int32 of the LLR pairs [rows, T, 2] float32
    (``viterbi_plain``'s arguments): the kernel on CUDA tensors, the plain
    version on CPU tensors."""
    if pairs.device.type == "cpu":
        return viterbi_plain(pairs, pinned)
    if pairs.device.type != "cuda":
        raise ValueError(f"viterbi: no kernel for {pairs.device}")
    _check(pairs, pinned)
    if not pairs.is_contiguous():
        raise ValueError("viterbi: pairs must be contiguous")
    R, T, _ = pairs.shape
    if R * T >= 1 << 62 or T >= 1 << 31 or R >= 1 << 31:
        raise ValueError(f"viterbi: {R} x {T} steps too many for the kernel")
    flags = pinned.contiguous().view(torch.uint8)  # the same bytes: no copy
    # the kernel's decision words: 4 ceil(T / 4) 64-bit words a row
    dec = torch.empty((R, 4 * (-(-T // 4))), dtype=torch.int64,
                      device=pairs.device)
    bits = torch.empty((R, T), dtype=torch.int32, device=pairs.device)
    fn = _kernel_fn()
    with torch.cuda.device(pairs.device):
        err = fn(pairs.data_ptr(), flags.data_ptr(), R, T, dec.data_ptr(),
                 bits.data_ptr(),
                 torch.cuda.current_stream(pairs.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"viterbi kernel launch failed: CUDA error {err}")
    viterbi.launches += 1
    return bits


viterbi.launches = 0
