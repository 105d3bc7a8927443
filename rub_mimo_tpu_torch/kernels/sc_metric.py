"""Schmidl&Cox timing metric over a whole capture (K6).

Port of rub_mimo_tpu/kernels/sc_metric.py::sc_metric_pallas.  On CUDA
tensors ``sc_metric_fused`` launches the hand-written Hopper kernel
csrc/sc_metric.cu (one launch of a persistent grid: each block walks a
contiguous span of the rows' chunks in order, keeps the window's
M-sample history in a ring in shared memory from chunk to chunk, copies
the next chunk's samples while it forms this chunk's metric from
chunk-local prefix sums, and counts zeros only in a window that holds
one; see the source note); on CPU tensors it runs
``sc_metric_reference``, the plain moving-sum version that the tests and
chip_smoke.py hold the kernel against.  There is no fallback: a CUDA
call that the kernel cannot take, or whose build or launch fails,
raises.  ``span_scan_emulation`` replays the kernel's plan on the CPU
for the tests.

The plain moving sums here are also the ones sync.schmidl_cox uses for
its correlation (the CFO observable).
"""

from __future__ import annotations

import ctypes
import functools

import torch

from rub_mimo_tpu_torch.utils.movsum import delay, moving_sum


def moving_corr_energy(x: torch.Tensor, M: int, *, block: int = 1 << 15):
    """The S&C moving sums for rows x [..., T] complex (framing.cc:626-637):
    corr[t] = -sum_{k<M/2} conj(x[t-k-M/2]) x[t-k] (complex64) and
    energy[t] = 0.5 sum_{k<M} |x[t-k]|^2 (float32), zeros before t=0."""
    M2 = M // 2
    prod = torch.conj(delay(x, M2)) * x
    corr = -moving_sum(prod, M2, block=block)
    energy = 0.5 * moving_sum(x.real ** 2 + x.imag ** 2, M, block=block)
    return corr, energy


def metric_from(corr: torch.Tensor, energy: torch.Tensor) -> torch.Tensor:
    """|corr|^2 / energy^2: NaN where the window is all zeros."""
    return (corr.real ** 2 + corr.imag ** 2) / (energy * energy)


def sc_metric_reference(x: torch.Tensor, M: int, *,
                        block: int = 1 << 15) -> torch.Tensor:
    """Plain PyTorch S&C metric [S, T] float32 of x [S, T] complex64."""
    return metric_from(*moving_corr_energy(x, M, block=block))


def supported(M: int) -> bool:
    """Geometry gate of the CUDA S&C kernels (K5, K6): M a multiple of 32
    in [32, 4096]."""
    return 32 <= M <= 4096 and M % 32 == 0


def check_capture(name: str, x: torch.Tensor, M: int, max_streams: int):
    """Raise ValueError for a capture the CUDA S&C kernels do not take."""
    if x.dtype != torch.complex64:
        raise ValueError(f"{name}: x must be complex64, got {x.dtype}")
    if x.dim() != 2 or not 1 <= x.shape[0] <= max_streams:
        raise ValueError(f"{name}: x must be [S, T] with 1 <= S <= "
                         f"{max_streams}, got {tuple(x.shape)}")
    if not 1 <= x.shape[1] < (1 << 30):
        raise ValueError(f"{name}: need 1 <= T < 2**30, got {x.shape[1]}")
    if not x.is_contiguous():
        raise ValueError(f"{name}: x must be contiguous")
    if not supported(M):
        raise ValueError(f"{name}: the kernel does not take M={M} "
                         "(a multiple of 32 in [32, 4096])")


def window_len(M: int) -> int:
    """The kernel's window for M: 256 threads of 16 samples up to
    M = 2048, 512 above; a power of two, the ring's length."""
    return (256 if M <= 2048 else 512) * 16


def chunk_len(M: int) -> int:
    """The kernel's chunk: output positions per chunk for M."""
    return window_len(M) - M


def span_scan_emulation(x: torch.Tensor, M: int, grid: int):
    """The kernel's plan replayed on x [S, T] complex64 (CPU) by ``grid``
    blocks; only tests use it.

    The rows are cut into chunks of ``chunk_len(M)`` positions, the
    chunks in row-major order into one contiguous span per block (block b
    takes [b N / G, (b + 1) N / G) of N chunks, G = min(N, grid)).  A
    block keeps a ring of ``window_len(M)`` samples, sample g at slot
    g mod W, that starts as NaN.  Its first chunk, and a chunk where its
    span enters the next row, load the whole window [c0 - M, c0 + C)
    (zeros before 0 and at or past T); a chunk that continues the row
    loads only its C new samples and reads its M-sample history from the
    ring.  Each chunk's prefix sums restart at its window; the nonzero
    counts are formed, and decide NaN, only in a window with a zero.

    Returns (metric [S, T] float32, writes [S, T] int32: how often each
    output was written, samples loaded)."""
    S, T = x.shape
    W, M2 = window_len(M), M // 2
    C = W - M
    row_chunks = -(-T // C)
    n_chunks = S * row_chunks
    G = min(n_chunks, grid)
    metric = torch.full((S, T), float("nan"))
    writes = torch.zeros((S, T), dtype=torch.int32)
    j = torch.arange(W)
    loaded = 0

    def load(ring, s, g0, n):
        g = g0 + torch.arange(n)
        inside = (g >= 0) & (g < T)
        ring[g % W] = torch.where(inside, x[s, g.clamp(0, T - 1)], 0)
        return n

    for b in range(G):
        q, q_end = b * n_chunks // G, (b + 1) * n_chunks // G
        ring = torch.full((W,), complex(float("nan"), float("nan")),
                          dtype=torch.complex64)
        s, k = divmod(q, row_chunks)
        loaded += load(ring, s, k * C - M, W)
        while True:
            c0 = k * C
            win = ring[(c0 - M + j) % W]
            prod = torch.where(j >= M2, torch.conj(torch.roll(win, M2)) * win,
                               0)
            P = torch.cumsum(prod, 0)
            E = torch.cumsum(win.real ** 2 + win.imag ** 2, 0)
            i = torch.arange(min(C, T - c0))
            o = M + i
            m = metric_from(-(P[o] - P[o - M2]), 0.5 * (E[o] - E[o - M]))
            nz = win != 0
            if not bool(nz.all()):
                cnt = torch.cumsum(nz.to(torch.int64), 0)
                m = torch.where(cnt[o] == cnt[o - M], float("nan"), m)
            metric[s, c0 + i] = m
            writes[s, c0 + i] += 1
            q += 1
            if q == q_end:
                break
            ns, k = divmod(q, row_chunks)
            if ns == s:
                loaded += load(ring, s, c0 + C, C)
            else:
                loaded += load(ring, ns, -M, W)
            s = ns
    return metric, writes, loaded


@functools.lru_cache(maxsize=None)
def _kernel():
    from rub_mimo_tpu_torch.kernels import _build

    lib = _build.load("sc_metric")
    P, I = ctypes.c_void_p, ctypes.c_int
    lib.sc_metric.argtypes = [P, I, I, I, P, P]
    lib.sc_metric.restype = I
    lib.sc_metric_geometry.argtypes = [I, I, I, P]
    lib.sc_metric_geometry.restype = I
    return lib


def metric_geometry(S: int, T: int, M: int, device=None) -> dict:
    """The launch's persistent grid on a CUDA device for an [S, T] capture
    and M (the occupancy calculator's blocks per SM x SMs, at most one
    block per chunk), its threads, chunk length and dynamic shared
    memory.  Launches nothing."""
    geo = (ctypes.c_int * 6)()
    with torch.cuda.device(device):
        err = _kernel().sc_metric_geometry(S, T, M, geo)
    if err != 0:
        raise RuntimeError(f"sc_metric_geometry failed: CUDA error {err}")
    return dict(zip(("grid", "blocks_per_sm", "sms", "threads", "chunk",
                     "smem_bytes"), geo))


def sc_metric_fused(x: torch.Tensor, M: int, *,
                    block: int = 1 << 15) -> torch.Tensor:
    """S&C metric [S, T] float32 of x [S, T] complex64.

    ``block`` is the chunk of the plain version's moving sums (CPU
    tensors); the kernel's chunks are its own."""
    if x.device.type == "cpu":
        return sc_metric_reference(x, M, block=block)
    if x.device.type != "cuda":
        raise ValueError(f"sc_metric_fused: no kernel for {x.device}")
    check_capture("sc_metric_fused", x, M, 65535)
    S, T = x.shape
    lib = _kernel()
    metric = torch.empty((S, T), dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        err = lib.sc_metric(x.data_ptr(), S, T, M, metric.data_ptr(),
                            torch.cuda.current_stream(x.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"sc_metric kernel launch failed: CUDA error {err}")
    sc_metric_fused.launches += 1
    return metric


sc_metric_fused.launches = 0
