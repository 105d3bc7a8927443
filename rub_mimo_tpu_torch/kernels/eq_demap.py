"""Equalize + hard demap (K3) and hard demap alone (K4).

Port of rub_mimo_tpu/kernels/eq_demap.py::eq_demap and ::demap.  On CUDA
tensors each wrapper launches its hand-written Hopper kernel in
csrc/eq_demap.cu; on CPU tensors it runs its plain version:

  eq_demap  ``eq_demap_reference``: detect.zf.equalize, then
            ofdm.constellation.hard_demap;
  demap     ofdm.constellation.hard_demap.

Both kernels decide through a decision-region search
(csrc/demap_search.cuh): ``region_table`` builds, on the host from the
points, a grid of cells over the box [-R, R]^2 with each cell's
candidate points, and the kernel scores only a symbol's cell's
candidates (none where a cell has one); the full scan of every point
decides outside the box, on NaN and Inf.  The decisions equal the full
scan's.  ``region_demap_emulation`` replays the search on the CPU, and
``eq_block_plan``, ``demap_plan`` and ``plan_writes`` K3's blocks and
K4's steps, for the tests.

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
from rub_mimo_tpu_torch.ofdm import constellation
from rub_mimo_tpu_torch.utils.device_cache import device_constant

MAX_EQ_POINTS = 64
MAX_DEMAP_POINTS = 256
# the region search (csrc/demap_search.cuh holds the same constants)
GRID = 64          # cells per axis
BOX = 2.5          # R = BOX * max|c|
SLOTS = 4          # candidates a cell word holds
MARGIN = 1e-3      # a cell is tested widened by this share of its side
FULL_SCAN = 0xFF   # the word of a cell that the full scan decides
EQ_THREADS = 256   # K3: subcarriers per block
DEMAP_THREADS = 256  # K4: threads per block
FILL_BLOCKS = 4    # K4 takes four symbols a thread where that gives every
                   # SM this many blocks, else one


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


# ---- the decision-region table (host) ----

def score_tolerance(table: np.ndarray) -> float:
    """How far one point must beat another at a cell's corners to drop
    it: 64 units in the last place (2^-24) of the largest score term
    magnitude at |y| <= sqrt(2) R, |Re y Re c| + |Im y Im c| + |c|^2 / 2.
    Two float32 scores, each two FMAs (the kernel) or three rounded
    operations (hard_demap), round by at most 6 such units together."""
    cmax = float(np.abs(np.asarray(table, np.complex64)).max())
    box = float(np.float32(BOX * cmax))
    return 64 * 2.0 ** -24 * (np.sqrt(2) * box * cmax + cmax * cmax / 2)


def region_geometry(table: np.ndarray):
    """(box, scale) as float32: R = BOX max|c| and GRID / (2 R).  The
    cell of y is ((Re y + box) * scale, (Im y + box) * scale), each
    truncated and clamped to GRID - 1."""
    cmax = float(np.abs(np.asarray(table, np.complex64)).max())
    box = np.float32(BOX * cmax)
    return box, np.float32(GRID / (2.0 * float(box)))


@functools.lru_cache(maxsize=16)
def _region_words(table_bytes: bytes) -> np.ndarray:
    table = np.frombuffer(table_bytes, dtype=np.complex64)
    cr, ci, cb = constellation.demap_planes(table).astype(np.float64)
    box, scale = (float(v) for v in region_geometry(table))
    side = 1.0 / scale
    half = side * (0.5 + MARGIN)
    tol = score_tolerance(table)
    # s_p - s_q is affine in y, so its least value over the widened cell
    # is its value at the centre less half (|dRe c| + |dIm c|); only the
    # points that the centre's best does not beat need the other points
    spread = (np.abs(cr[:, None] - cr[None, :])
              + np.abs(ci[:, None] - ci[None, :]))
    centre = -box + (np.arange(GRID) + 0.5) * side
    cells = np.arange(GRID)
    words = np.empty(GRID * GRID, np.uint32)
    for iy in range(GRID):
        s = centre[:, None] * cr + centre[iy] * ci - cb  # [ix, K]
        best = s.argmax(axis=1)
        near = (s[cells, best][:, None] - s - half * spread[best]) <= tol
        for ix in range(GRID):
            qs = np.flatnonzero(near[ix])
            beaten = ((s[ix, :, None] - s[ix, qs] - half * spread[:, qs])
                      > tol).any(axis=0)
            cand = qs[~beaten]
            if len(cand) > SLOTS:
                words[iy * GRID + ix] = FULL_SCAN
                continue
            slots = np.concatenate(
                [cand, np.full(SLOTS - len(cand), cand[-1])])
            words[iy * GRID + ix] = sum(int(q) << (8 * i)
                                        for i, q in enumerate(slots))
    return words


def region_table(table: np.ndarray) -> np.ndarray:
    """The cell words [GRID * GRID] uint32 of ``table``, row iy, column
    ix: up to SLOTS candidate indices, one byte each, ascending, the last
    repeated into the unused slots; FULL_SCAN (255 then 0, never an
    ascending list) where more than SLOTS points are candidates.  A point
    is a candidate of a cell unless a single other point scores more
    than ``score_tolerance`` above it at all four corners of the cell
    widened by MARGIN of its side on each side."""
    return _region_words(np.asarray(table, np.complex64).tobytes())


def cell_candidates(word: int) -> list:
    """The candidate indices of a cell word (empty for FULL_SCAN)."""
    if word == FULL_SCAN:
        return []
    slots = [(word >> (8 * i)) & 0xFF for i in range(SLOTS)]
    return [q for i, q in enumerate(slots) if i == 0 or q != slots[i - 1]]


@device_constant
def _device_table(table_bytes: bytes, device: torch.device) -> torch.Tensor:
    table = np.frombuffer(table_bytes, dtype=np.complex64)
    pts = np.zeros((len(table), 4), np.float32)
    pts[:, :3] = constellation.demap_planes(table).T
    buf = np.concatenate([_region_words(table_bytes).view(np.int32),
                          pts.reshape(-1).view(np.int32)])
    return torch.as_tensor(buf, device=device)


def region_demap_emulation(y: torch.Tensor, table: np.ndarray
                           ) -> torch.Tensor:
    """The kernels' search replayed on CPU symbols y (any shape): the box
    test, the cell, its candidates in ascending order with the first
    maximum winning (one candidate decides alone), and the full scan
    (strict '>', so NaN scores never win) outside the box, on NaN, Inf
    and FULL_SCAN cells.  Scores use hard_demap's float32 arithmetic.
    Returns int32 decisions of y's shape."""
    c = torch.as_tensor(constellation.demap_planes(table))
    words = torch.as_tensor(region_table(table).astype(np.int64))
    box, scale = region_geometry(table)
    yr = y.real.float().reshape(-1)
    yi = y.imag.float().reshape(-1)

    def score(q):
        return yr * c[0, q] + yi * c[1, q] - c[2, q]

    inside = (yr.abs() < box) & (yi.abs() < box)
    ix = ((torch.where(inside, yr, 0.0) + box) * scale).to(torch.int64)
    iy = ((torch.where(inside, yi, 0.0) + box) * scale).to(torch.int64)
    w = words[iy.clamp(max=GRID - 1) * GRID + ix.clamp(max=GRID - 1)]
    full = ~inside | (w == FULL_SCAN)
    best = torch.full_like(yr, float("-inf"))
    idx = torch.zeros_like(w)
    prev = None
    for s in range(SLOTS):
        q = torch.where(full, 0, (w >> (8 * s)) & 0xFF)
        fresh = torch.ones_like(full) if prev is None else q != prev
        sc = score(q)
        take = fresh & (sc > best)
        best = torch.where(take, sc, best)
        idx = torch.where(take, q, idx)
        prev = q
    one = ((w >> 8) & 0xFF) == (w & 0xFF)
    idx = torch.where(one, w & 0xFF, idx)
    fbest = torch.full_like(yr, float("-inf"))
    fidx = torch.zeros_like(w)
    for q in range(len(table)):
        sc = score(q)
        take = sc > fbest
        fbest = torch.where(take, sc, fbest)
        fidx = torch.where(take, q, fidx)
    return torch.where(full, fidx, idx).to(torch.int32).reshape(y.shape)


def probe_symbols(table: np.ndarray, n: int, seed: int) -> np.ndarray:
    """n complex64 symbols (n >= 64) that reach every path of the search
    over ``table``, for the tests and chip_smoke.py: in equal shares, the
    points plus noise, uniform over the box, a part on a cell edge (to
    within one unit in the last place), the midpoint of two random
    points (a tie in exact arithmetic), that midpoint moved by up to
    1e-6, and outside the box (up to 3 R); then 0, NaN and +-Inf in each
    part, each with a finite other part."""
    rng = np.random.default_rng(seed)
    t = np.asarray(table, np.complex64)
    box, scale = (float(v) for v in region_geometry(t))
    m = (n - 9) // 6
    noisy = t[rng.integers(0, len(t), m)] + 0.1 * box * (
        rng.standard_normal(m) + 1j * rng.standard_normal(m))
    uniform = rng.uniform(-box, box, m) + 1j * rng.uniform(-box, box, m)
    edge = np.float32(-box + rng.integers(0, GRID + 1, m) / scale)
    edge = np.nextafter(edge, np.float32(np.inf) * rng.choice([-1, 1], m))
    edge = np.where(rng.random(m) < 0.5, edge, np.float32(
        -box + rng.integers(0, GRID + 1, m) / scale))
    other = rng.uniform(-box, box, m)
    edges = np.where(rng.random(m) < 0.5, edge + 1j * other,
                     other + 1j * edge)
    pairs = rng.integers(0, len(t), (2, m))
    mid = (t[pairs[0]].astype(np.complex128) + t[pairs[1]]) / 2
    near = mid + rng.uniform(-1e-6, 1e-6, m) + 1j * rng.uniform(-1e-6, 1e-6,
                                                                 m)
    rad = rng.uniform(box, 3 * box, m) * np.exp(
        2j * np.pi * rng.random(m))
    inf, nan = np.inf, np.nan
    special = np.zeros(9, np.complex64)
    special.real = [0, nan, 0, nan, inf, -inf, 0.3, 0.3, -0.0]
    special.imag = [0, 0, nan, nan, 0.3, 0.3, inf, -inf, -0.0]
    out = np.concatenate([noisy, uniform, edges, mid, near, rad, special])
    out = np.concatenate([out, uniform[:n - len(out)]])
    return out.astype(np.complex64)


# ---- the launch plans ----

def eq_block_plan(M: int, n_sym: int, blocks_per_sm: int, sms: int) -> dict:
    """K3's grid (csrc/eq_demap.cu::eq_plan): tiles of EQ_THREADS
    subcarriers times as many frame ranges as fill one wave of
    blocks_per_sm * sms blocks (at least one, at most n_sym); block b
    takes tile b % tiles and frames b // tiles, + ranges, ..."""
    tiles = -(-M // EQ_THREADS)
    ranges = min(n_sym, max(1, blocks_per_sm * sms // tiles))
    return {"tiles": tiles, "ranges": ranges, "grid": tiles * ranges,
            "threads": EQ_THREADS}


def demap_plan(n: int, head: int, blocks_per_sm: int, sms: int) -> dict:
    """K4's launch (csrc/eq_demap.cu::demap_grid) for n symbols of which
    ``head`` (0 or 1) come before the first 16-byte aligned one:
    ``per_thread`` symbols a thread and step (four where that gives
    every SM FILL_BLOCKS blocks, else one, and then no head), one thread
    per step, at most one wave of blocks."""
    V = 4 if (n - head) // 4 >= FILL_BLOCKS * sms * DEMAP_THREADS else 1
    h = head if V == 4 else 0
    need = -(-((n - h) // V) // DEMAP_THREADS)
    return {"per_thread": V, "head": h,
            "grid": max(1, min(need, blocks_per_sm * sms))}


def plan_writes(kind: str, *, M: int = 0, n_sym: int = 0, n: int = 0,
                head: int = 0, blocks_per_sm: int = 1,
                sms: int = 1) -> torch.Tensor:
    """How often each output is written when the kernel's blocks and
    threads walk their plan (tests only).  kind "eq_demap": [n_sym, M]
    (every stream of a (frame, subcarrier) has the same thread); "demap":
    [n]."""
    if kind == "eq_demap":
        p = eq_block_plan(M, n_sym, blocks_per_sm, sms)
        writes = torch.zeros((n_sym, M), dtype=torch.int32)
        for b in range(p["grid"]):
            tile, r = b % p["tiles"], b // p["tiles"]
            sc = torch.arange(tile * EQ_THREADS, (tile + 1) * EQ_THREADS)
            writes[r::p["ranges"], sc[sc < M]] += 1
        return writes
    plan = demap_plan(n, head, blocks_per_sm, sms)
    V, h = plan["per_thread"], plan["head"]
    stride = plan["grid"] * DEMAP_THREADS
    nv, writes = (n - h) // V, torch.zeros(n, dtype=torch.int32)
    rest = n - h - V * nv
    # block 0's first threads: the head, then the symbols after the steps
    writes[[0] * h + [h + V * nv + t for t in range(rest)]] += 1
    for t in range(min(stride, nv)):  # thread t: steps t, t + stride, ...
        for v in range(t, nv, stride):
            writes[h + V * v:h + V * v + V] += 1
    return writes


# ---- the kernels ----

@functools.lru_cache(maxsize=None)
def _lib():
    from rub_mimo_tpu_torch.kernels import _build

    lib = _build.load("eq_demap")
    P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    L = ctypes.c_longlong
    lib.hard_demap.argtypes = [P, L, P, I, F, F, P, P]
    lib.hard_demap.restype = I
    lib.demap_geometry.argtypes = [L, I, P]
    lib.demap_geometry.restype = I
    lib.eq_demap.argtypes = [P, P, P, P, I, F, F, I, I, I, P, P, P]
    lib.eq_demap.restype = I
    lib.eq_demap_geometry.argtypes = [I, I, I, P]
    lib.eq_demap_geometry.restype = I
    return lib


def device_table(table: np.ndarray, device: torch.device) -> torch.Tensor:
    """The kernels' table of ``table`` on ``device``: the cell words
    (``region_table``), then the points as float4 (Re c, Im c,
    |c|^2 / 2, 0), as int32 words; cached per table and device (a host
    to device copy per call would synchronize the stream)."""
    return _device_table(np.asarray(table, np.complex64).tobytes(), device)


def launch_geometry(kind: str, *args, device=None) -> dict:
    """A launch's grid on a CUDA device, launching nothing.
    ``launch_geometry("eq_demap", S, M, n_sym)``: K3's tiles, frame
    ranges, blocks per SM, SMs and threads;
    ``launch_geometry("demap", n, head)``: K4's symbols a thread and step,
    grid, blocks per SM, SMs and threads for n symbols of which ``head``
    (0 or 1) come before the first 16-byte aligned one."""
    out = (ctypes.c_int * 6)()
    with torch.cuda.device(device):
        if kind == "eq_demap":
            S, M, n_sym = args
            err = _lib().eq_demap_geometry(S, M, n_sym, out)
            keys = ("tiles", "ranges", "blocks_per_sm", "sms", "threads")
        else:
            n, head = args
            err = _lib().demap_geometry(n, head, out)
            keys = ("per_thread", "grid", "blocks_per_sm", "sms",
                    "threads")
    if err != 0:
        raise RuntimeError(f"{kind} geometry failed: CUDA error {err}")
    return dict(zip(keys, list(out)))


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
    rx_data = torch.empty((S, n_sym, M), dtype=torch.int32, device=dev)
    rx_sig = (torch.empty((S, n_sym, M), dtype=torch.complex64, device=dev)
              if emit_sig else None)
    box, scale = region_geometry(table)
    with torch.cuda.device(dev):
        err = _lib().eq_demap(
            X.data_ptr(), W.data_ptr(), gain.data_ptr(),
            device_table(table, dev).data_ptr(), len(table), float(box),
            float(scale), S, M, n_sym, rx_data.data_ptr(),
            None if rx_sig is None else rx_sig.data_ptr(),
            torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"eq_demap kernel launch failed: CUDA error {err}")
    eq_demap.launches += 1
    return rx_sig, rx_data


eq_demap.launches = 0


def _check_demap(y: torch.Tensor, table: np.ndarray, name: str) -> None:
    if y.device.type != "cuda":
        raise ValueError(f"{name}: no kernel for {y.device}")
    if y.dtype != torch.complex64:
        raise ValueError(f"{name}: y must be complex64, got {y.dtype}")
    if not y.is_contiguous():
        raise ValueError(f"{name}: y must be contiguous")
    if y.numel() < 1:
        raise ValueError(f"{name}: y is empty")
    if not 1 <= len(table) <= MAX_DEMAP_POINTS:
        raise ValueError(f"{name} kernel does not take {len(table)} points "
                         f"(at most {MAX_DEMAP_POINTS})")


def _launch_demap(y: torch.Tensor, table: np.ndarray,
                  dev_table: torch.Tensor) -> torch.Tensor:
    box, scale = region_geometry(table)
    out = torch.empty(y.shape, dtype=torch.int32, device=y.device)
    with torch.cuda.device(y.device):
        err = _lib().hard_demap(
            y.data_ptr(), y.numel(), dev_table.data_ptr(), len(table),
            float(box), float(scale), out.data_ptr(),
            torch.cuda.current_stream(y.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"demap kernel launch failed: CUDA error {err}")
    demap.launches += 1
    return out


def demap(y: torch.Tensor, table: np.ndarray) -> torch.Tensor:
    """Nearest-neighbour decisions (int32, y's shape) of complex64 symbols
    y over ``table`` (at most 256 points): argmax_k Re(y) Re(c_k) +
    Im(y) Im(c_k) - |c_k|^2 / 2, the first maximum winning."""
    if y.device.type == "cpu":
        return constellation.hard_demap(y, table)
    _check_demap(y, table, "demap")
    return _launch_demap(y, table, device_table(table, y.device))


demap.launches = 0


@functools.lru_cache(maxsize=16)
def _full_scan_table(table_bytes: bytes, device: torch.device):
    words = np.full(GRID * GRID, FULL_SCAN, np.uint32).view(np.int32)
    pts = _device_table(table_bytes, device)[GRID * GRID:]
    return torch.cat([torch.as_tensor(words, device=device), pts])


def demap_full_scan(y: torch.Tensor, table: np.ndarray) -> torch.Tensor:
    """K4 launched with a table whose every cell sends its symbols to the
    full scan: the kernel's own scan of every point, which the region
    search must equal bit for bit (the card tests and chip_smoke.py hold
    them to it).  CUDA tensors only; counted in ``demap.launches``."""
    _check_demap(y, table, "demap_full_scan")
    return _launch_demap(y, table, _full_scan_table(
        np.asarray(table, np.complex64).tobytes(), y.device))
