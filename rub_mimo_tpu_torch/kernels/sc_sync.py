"""The whole Schmidl&Cox sync stage in one kernel call (K5).

Port of rub_mimo_tpu/kernels/sc_sync.py::sc_sync_fused.  On CUDA tensors
``sc_sync_fused`` launches the hand-written Hopper kernel csrc/sc_sync.cu
(two launches on the current stream: a persistent scan that takes chunks
of the capture in order, writes each chunk's above-threshold bits, its
first and last below-threshold index and its first fire past its head,
and stops after the fire; then one block that settles the chunks' heads
with the carry and writes t*, the run starts and the correlation; see the
source note); on CPU tensors it runs ``sc_sync_reference``, the plain
version the tests and chip_smoke.py hold the kernel against.  There is no
fallback: a CUDA call that the kernel cannot take, or whose build or
launch fails, raises.  Nothing is read back to the host.

``plateau_scan`` is the plain plateau state machine, shared with the full
scan of sync.schmidl_cox; its running maximum is ``cummax``, a two-level
scan that the sharded decode's full-rate stage A uses too.
``chunk_scan_emulation`` replays the kernel's two launches on a metric
for the CPU tests.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch
import torch.nn.functional as F

from rub_mimo_tpu_torch.kernels import sc_metric as k6

MAX_STREAMS = 8
NO_INDEX = 0x7FFFFFFF  # the kernel's "none": no below sample, no fire


def cummax(x: torch.Tensor, chunk: int = 1024) -> torch.Tensor:
    """torch.cummax(x, dim=-1).values of an integer [R, L] tensor as a
    two-level scan: running maxima within chunks of ``chunk`` samples (many
    short rows), then each chunk raised to the maximum of the chunks
    before it.  torch.cummax alone scans each row in one thread block, and
    a capture's rows are few and long (1.56 ms for [2, 574,336] int64 on
    an H100)."""
    R, L = x.shape
    n = -(-L // chunk)
    low = torch.iinfo(x.dtype).min
    c = torch.cummax(F.pad(x, (0, n * chunk - L), value=low)
                     .reshape(R * n, chunk), dim=-1).values
    c = c.reshape(R, n, chunk)
    before = F.pad(torch.cummax(c[:, :-1, -1], dim=-1).values, (1, 0),
                   value=low)
    return torch.maximum(c, before[:, :, None]).reshape(R, n * chunk)[:, :L]


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
    last_below = cummax(torch.where(above, torch.full_like(idx, -1), idx))
    run_start = last_below + 1
    cond = above & ((idx - run_start) > cp_len)
    fire = cond.sum(dim=0) >= q
    t_star = torch.argmax(fire.to(torch.uint8))
    # index_select at a device scalar: x[t_star] would read it back
    at = t_star.reshape(1)
    return (fire.index_select(0, at)[0], t_star,
            run_start.index_select(1, at)[:, 0], cond.index_select(1, at)[:, 0])


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
    return synced, t_star, starts, corr.index_select(1, t_star.reshape(1))[:, 0]


def chunk_scan_emulation(metric: torch.Tensor, cp_len: int,
                         threshold: float, chunk: int, grid: int = 1):
    """The kernel's two launches replayed on metric [S, T] with chunks of
    ``chunk`` positions; only tests use it.

    Launch 1 hands out chunks in capture order to ``grid`` resident
    blocks, modelled as waves of ``grid`` tickets that each read the bound
    as it stood when the wave began; a chunk that starts past it is not
    scanned, and the scan stops there.  A scanned chunk records each
    stream's first and last below-threshold index and lowers the bound to
    its first body fire (t >= c0 + cp + 1, where every stream is above on
    [t - cp - 1, t]).  Launch 2 takes each chunk's carry as the exclusive
    prefix max of the earlier chunks' last below, finds the first head
    fire h = max(c0, max carry + cp + 2) (if h <= c0 + cp, h < T and h
    lies before every stream's first below in the chunk), and sets t* =
    min(bound, h); the run starts at t* come from the carry and the bits
    of t*'s chunk.

    Returns (synced, t_star, run_start[S] at t*, chunks scanned), the
    first three as ``plateau_scan`` gives them."""
    S, T = metric.shape
    C = chunk
    n_chunks = -(-T // C)
    above = metric > threshold  # NaN > thr is False, as in C
    idx = torch.arange(T)
    first = torch.full((S, n_chunks), NO_INDEX, dtype=torch.int64)
    last = torch.full((S, n_chunks), -1, dtype=torch.int64)
    bound, scanned = NO_INDEX, 0
    for w0 in range(0, n_chunks, grid):
        seen = bound
        wave = [k for k in range(w0, min(w0 + grid, n_chunks))
                if k * C <= seen]
        if not wave:
            break
        for k in wave:
            c0, end = k * C, min(k * C + C, T)
            up, t = above[:, c0:end], idx[c0:end]
            below = torch.where(~up, t, torch.full_like(t, -1))
            last[:, k] = below.max(dim=1).values
            first[:, k] = torch.where(~up, t, torch.full_like(
                t, NO_INDEX)).min(dim=1).values
            # the last zero of the streams' AND before t, c0 - 1 at most
            lz = torch.cummax(torch.where(up.all(dim=0), c0 - 1, t),
                              dim=0).values
            body = torch.nonzero(t - lz > cp_len + 1)
            if body.numel():
                bound = min(bound, int(t[body[0, 0]]))
            scanned += 1
    n_live = n_chunks if bound == NO_INDEX else min(n_chunks, bound // C + 1)
    carry = torch.full((S,), -1, dtype=torch.int64)
    head = NO_INDEX
    for k in range(n_live):
        c0 = k * C
        h = max(c0, int(carry.max()) + cp_len + 2)
        if (h <= min(c0 + cp_len, min(c0 + C, T) - 1)
                and h < int(first[:, k].min())):
            head = h
            break
        carry = torch.maximum(carry, last[:, k])
    fire = min(head, bound)
    synced = fire != NO_INDEX
    t = fire if synced else 0
    b = t // C
    lb = last[:, :b].max(dim=1).values if b else torch.full(
        (S,), -1, dtype=torch.int64)
    seg = idx[b * C:t + 1]
    lb = torch.maximum(lb, torch.where(~above[:, b * C:t + 1], seg,
                                       torch.full_like(seg, -1))
                       .max(dim=1).values)
    return torch.tensor(synced), torch.tensor(t), lb + 1, scanned


@functools.lru_cache(maxsize=None)
def _kernel():
    from rub_mimo_tpu_torch.kernels import _build

    lib = _build.load("sc_sync")
    P, I = ctypes.c_void_p, ctypes.c_int
    lib.sc_sync.argtypes = [P, I, I, I, I, ctypes.c_float,
                            P, P, P, P, P, P, P, P, P]
    lib.sc_sync.restype = I
    lib.sc_sync_chunk_len.argtypes = [I]
    lib.sc_sync_chunk_len.restype = I
    lib.sc_sync_geometry.argtypes = [I, I, I, P]
    lib.sc_sync_geometry.restype = I
    return lib


def chunk_len(M: int) -> int:
    """The kernel's chunk: output positions per ticket for M."""
    return _kernel().sc_sync_chunk_len(M)


def scan_geometry(S: int, T: int, M: int, device=None) -> dict:
    """Launch 1's persistent grid on a CUDA device for an [S, T] capture
    and M (the occupancy calculator's blocks per SM x SMs, at most one
    block per chunk).  Launches nothing."""
    geo = (ctypes.c_int * 6)()
    with torch.cuda.device(device):
        err = _kernel().sc_sync_geometry(S, T, M, geo)
    if err != 0:
        raise RuntimeError(f"sc_sync_geometry failed: CUDA error {err}")
    return dict(zip(("grid", "blocks_per_sm", "sms", "threads", "chunk",
                     "smem_bytes"), geo))


def sc_sync_fused(x: torch.Tensor, M: int, cp_len: int, threshold: float,
                  *, block: int = 1 << 15):
    """One-pass sync of x [S, T] complex64 with the all-streams rule:
    (synced bool, t_star int64, starts int64 [S], corr_at complex64 [S]),
    all on x's device.  ``block`` is the chunk of the plain version's
    moving sums (CPU tensors); the kernel's chunks are its own.  After a
    CUDA call, ``sc_sync_fused.chunks`` is its number of chunks and
    ``sc_sync_fused.chunks_scanned`` a device int32 scalar, the chunks
    its scan read (valid once the stream has run it)."""
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
    n_chunks = -(-T // lib.sc_sync_chunk_len(M))
    above = torch.empty((S, -(-T // 32)), dtype=torch.int32, device=dev)
    marks = torch.empty((2, S, n_chunks), dtype=torch.int32, device=dev)
    state = torch.empty((65,), dtype=torch.int32, device=dev)  # 3 lines
    synced = torch.empty((), dtype=torch.bool, device=dev)
    t_star = torch.empty((), dtype=torch.int64, device=dev)
    starts = torch.empty((S,), dtype=torch.int64, device=dev)
    corr = torch.empty((S,), dtype=torch.complex64, device=dev)
    with torch.cuda.device(dev):
        err = lib.sc_sync(x.data_ptr(), S, T, M, cp_len, float(threshold),
                          above.data_ptr(), marks[0].data_ptr(),
                          marks[1].data_ptr(), state.data_ptr(),
                          synced.data_ptr(), t_star.data_ptr(),
                          starts.data_ptr(), corr.data_ptr(),
                          torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"sc_sync kernel launch failed: CUDA error {err}")
    sc_sync_fused.launches += 1
    sc_sync_fused.chunks = n_chunks
    sc_sync_fused.chunks_scanned = state[64]
    return synced, t_star, starts, corr


sc_sync_fused.launches = 0
sc_sync_fused.chunks = 0
sc_sync_fused.chunks_scanned = None
