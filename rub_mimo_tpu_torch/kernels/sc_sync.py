"""The whole Schmidl&Cox sync stage in one kernel call (K5).

Port of rub_mimo_tpu/kernels/sc_sync.py::sc_sync_fused.  On CUDA tensors
``sc_sync_fused`` launches the hand-written Hopper kernel csrc/sc_sync.cu
(three launches on the current stream: per-tile metric and above-threshold
bits, the all-streams fire with a cross-tile carry of the last
below-threshold index, and the run starts and correlation at t*; see the
source note); on CPU tensors it runs ``sc_sync_reference``, the plain
version the tests and chip_smoke.py hold the kernel against.  There is no
fallback: a CUDA call that the kernel cannot take, or whose build or
launch fails, raises.  Nothing is read back to the host.

``plateau_scan`` is the plain plateau state machine, shared with the full
scan of sync.schmidl_cox.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch

from rub_mimo_tpu_torch.kernels import sc_metric as k6

MAX_STREAMS = 8


def plateau_scan(metric: torch.Tensor, cp_len: int, threshold: float,
                 quorum: Optional[int] = None):
    """Vectorized serial plateau state machine over metric [S, T].

    Returns (synced, t_star, run_start[S] at t*, participates[S] at t*).
    A stream's run start at t is (last index with metric <= thr before t)
    + 1; the fire condition at t is >= quorum (default all) streams with
    metric > thr and t - run_start > cp_len; t* is the first fire, 0 when
    nothing fires (framing.cc:601-623)."""
    S, T = metric.shape
    q = S if quorum is None else quorum
    above = metric > threshold  # NaN > thr is False, as in C
    idx = torch.arange(T, device=metric.device).expand(S, T)
    last_below = torch.cummax(
        torch.where(above, torch.full_like(idx, -1), idx), dim=1).values
    run_start = last_below + 1
    cond = above & ((idx - run_start) > cp_len)
    fire = cond.sum(dim=0) >= q
    t_star = torch.argmax(fire.to(torch.uint8))
    return fire[t_star], t_star, run_start[:, t_star], cond[:, t_star]


def sc_sync_reference(x: torch.Tensor, M: int, cp_len: int,
                      threshold: float, *, block: int = 1 << 15):
    """Plain version of the one-pass sync: the S&C metric, the
    all-streams plateau scan and corr[:, t*].  When nothing fires, t* = 0,
    the starts are the run starts at t = 0 and the correlation is the one
    at t = 0 (the JAX kernel's defaults, sc_sync.py:133-143).

    Returns (synced bool, t_star int64, starts int64 [S], corr_at
    complex64 [S])."""
    corr, energy = k6.moving_corr_energy(x, M, block=block)
    synced, t_star, starts, _ = plateau_scan(
        k6.metric_from(corr, energy), cp_len, threshold)
    return synced, t_star, starts, corr[:, t_star]


@functools.lru_cache(maxsize=None)
def _kernel():
    from rub_mimo_tpu_torch.kernels import _build

    lib = _build.load("sc_sync")
    P, I = ctypes.c_void_p, ctypes.c_int
    lib.sc_sync.argtypes = [P, I, I, I, I, ctypes.c_float,
                            P, P, P, P, P, P, P, P]
    lib.sc_sync.restype = I
    lib.sc_sync_tile_len.argtypes = [I]
    lib.sc_sync_tile_len.restype = I
    return lib


def sc_sync_fused(x: torch.Tensor, M: int, cp_len: int, threshold: float,
                  *, block: int = 1 << 15):
    """One-pass sync of x [S, T] complex64 with the all-streams rule:
    (synced bool, t_star int64, starts int64 [S], corr_at complex64 [S]),
    all on x's device.  ``block`` is the chunk of the plain version's
    moving sums (CPU tensors); the kernel's tiles are its own."""
    if x.device.type == "cpu":
        return sc_sync_reference(x, M, cp_len, threshold, block=block)
    if x.device.type != "cuda":
        raise ValueError(f"sc_sync_fused: no kernel for {x.device}")
    k6.check_capture("sc_sync_fused", x, M, MAX_STREAMS)
    if cp_len < 0:
        raise ValueError(f"sc_sync_fused: cp_len must be >= 0, got {cp_len}")
    S, T = x.shape
    dev = x.device
    lib = _kernel()
    n_tiles = -(-T // lib.sc_sync_tile_len(M))
    above = torch.empty((S, -(-T // 32)), dtype=torch.int32, device=dev)
    tile_lb = torch.empty((S, n_tiles), dtype=torch.int32, device=dev)
    tstar = torch.empty((1,), dtype=torch.int32, device=dev)
    synced = torch.empty((), dtype=torch.bool, device=dev)
    t_star = torch.empty((), dtype=torch.int64, device=dev)
    starts = torch.empty((S,), dtype=torch.int64, device=dev)
    corr = torch.empty((S,), dtype=torch.complex64, device=dev)
    with torch.cuda.device(dev):
        err = lib.sc_sync(x.data_ptr(), S, T, M, cp_len, float(threshold),
                          above.data_ptr(), tile_lb.data_ptr(),
                          tstar.data_ptr(), synced.data_ptr(),
                          t_star.data_ptr(), starts.data_ptr(),
                          corr.data_ptr(),
                          torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"sc_sync kernel launch failed: CUDA error {err}")
    sc_sync_fused.launches += 1
    return synced, t_star, starts, corr


sc_sync_fused.launches = 0
