"""Max-log-MAP bit LLRs of complex symbols, and the soft Viterbi's rows
made from them in one pass (no TPU counterpart).

The JAX package computes the LLRs in XLA ops
(rub_mimo_tpu/ofdm/constellation.py:222, ``soft_demodulate_llr``), with
no Pallas kernel, and then deinterleaves, depunctures and pads them into
the Viterbi's input in more XLA ops (rub_mimo_tpu/ofdm/fec.py,
``_decode_from_llrs``).  In PyTorch each of those is a pass over ~85 MB at
the operating point, so on CUDA tensors ``soft_llr_rows`` launches one
hand-written kernel, csrc/soft_llr.cu (see the source note), that
computes the LLRs and writes them straight into the Viterbi's rows: the
deinterleave, depuncture, pads and window overlap happen in its store.
It also takes LLRs in place of symbols (detect/ml.ml_soft_llrs's), with
the same map and no distances.  ``soft_llr`` is the same kernel with the
identity geometry: the LLRs [..., bits] in wire order.  On CPU tensors
each runs its plain version: ``soft_llr_plain``, the chunked PyTorch
body, and ``soft_llr_rows_plain``, the composition of soft_llr_plain,
fec.deinterleave, fec.depuncture_llrs and fec.viterbi_rows.  The kernel
computes the plain versions' values on the card bit for bit (NaN where
they have NaN).  There is no fallback: a CUDA call that the kernel cannot
take, or whose build or launch fails, raises.

``row_geometry`` gives the integers the kernel places its tiles by, and
``rows_emulation`` replays its index plan on the CPU on integer indices
(tests/test_torch_soft_llr_rows.py).
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import NamedTuple

import numpy as np
import torch

from rub_mimo_tpu_torch.utils.device_cache import device_constant

LLR_CHUNK = 1 << 19  # symbols a pass of soft_llr_plain
MAX_BITS = 8         # QAM256
TILE = 8704          # output floats a block at most (csrc kTile)
MAX_STRIDE = 256     # interleaver strides a block can stage (kMaxStride)
THREADS = 256        # threads a block (kThreads)


class RowPlan(NamedTuple):
    """Where the Viterbi's rows of a lane take their LLRs from (ofdm/fec.py's
    coded decode): the lane's wire LLRs deinterleaved with the stride
    ``stride`` (1: not interleaved; else coprime to the lane's LLR count),
    the first ``fec._kept_bits(used, rate)`` of them depunctured into
    ``used`` mother-coded LLRs, cut into rows by
    ``fec.viterbi_rows(..., window, margin)``."""
    used: int
    rate: str = "1/2"
    stride: int = 1
    window: int | None = None
    margin: int = 128


class Geometry(NamedTuple):
    """The kernel's integers, in the order its ``geom`` argument takes
    them (csrc/soft_llr.cu, struct Plan)."""
    lane_in: int   # input elements a lane (symbols, or LLRs)
    n: int         # wire LLRs a lane
    used: int      # mother-coded positions a lane
    wq: int        # positions between two rows' starts (2 window)
    mq: int        # positions before a row's first own one (2 margin)
    out_len: int   # floats a row (2 steps)
    rows: int      # rows a lane
    tiles: int     # tiles (blocks) a row
    tile: int      # floats a tile
    stride: int    # interleaver stride s
    ninv: int      # (n mod s)^-1 mod s
    period: int    # puncture period P
    pattern: int   # bit i set: position i of a period is kept


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


def soft_llr_rows_plain(x: torch.Tensor, plan: RowPlan, points=None,
                        noise_var: float | torch.Tensor = 1.0):
    """The Viterbi's rows (pairs [lanes * rows, steps, 2] float32, pinned
    [lanes * rows] bool) of x: complex64 symbols [lanes, N] (their
    soft_llr_plain LLRs over ``points``) or float32 wire LLRs [lanes, n]:
    ``fec.viterbi_rows(fec.depuncture_llrs(fec.deinterleave(llrs)[:,
    :kept], used, rate), window, margin)`` as ``plan`` gives them."""
    from rub_mimo_tpu_torch.ofdm import fec

    llrs = (x if x.dtype == torch.float32
            else soft_llr_plain(x, points, noise_var)).reshape(x.shape[0], -1)
    if plan.stride > 1:
        llrs = fec.deinterleave(llrs, plan.stride)
    kept = fec._kept_bits(plan.used, plan.rate)
    llrs = fec.depuncture_llrs(llrs[:, :kept], plan.used, plan.rate)
    return fec.viterbi_rows(llrs, plan.window, plan.margin)


def _tiles(out_len: int) -> tuple:
    """(tiles a row, floats a tile): the fewest tiles of at most TILE."""
    tiles = -(-out_len // TILE)
    return tiles, -(-out_len // tiles)


def row_geometry(plan: RowPlan, n: int, lane_in: int) -> Geometry:
    """The kernel's integers for ``plan`` over lanes of n wire LLRs (lane_in
    input elements a lane).  Raises ValueError on a plan the kernel cannot
    take: fewer than kept(used) LLRs a lane, a stride not coprime to n or
    past MAX_STRIDE."""
    from rub_mimo_tpu_torch.ofdm import fec

    if plan.rate not in fec.PUNCTURE:
        raise ValueError(f"soft_llr_rows: no code rate {plan.rate!r}")
    if plan.used < 2 or plan.used % 2:
        raise ValueError("soft_llr_rows: used must be a positive even "
                         f"count of mother-coded LLRs, got {plan.used}")
    if fec._kept_bits(plan.used, plan.rate) > n:
        raise ValueError(f"soft_llr_rows: {n} LLRs a lane, fewer than the "
                         f"{fec._kept_bits(plan.used, plan.rate)} the rows "
                         "keep")
    s = int(plan.stride)
    if not 1 <= s <= MAX_STRIDE or math.gcd(s, n) != 1:
        raise ValueError(f"soft_llr_rows: stride {s} must be 1 to "
                         f"{MAX_STRIDE} and coprime to n = {n}")
    pat = fec.PUNCTURE[plan.rate] or (1,)
    T = plan.used // 2
    if plan.window is None:
        rows, out_len, wq, mq = 1, 2 * T, 2 * T, 0
    else:
        W, m = int(plan.window), int(plan.margin)
        if W < 1 or m < 0:
            raise ValueError("soft_llr_rows: window must be positive and "
                             "margin not negative")
        rows, out_len, wq, mq = -(-T // W), 2 * (W + 2 * m), 2 * W, 2 * m
    tiles, tile = _tiles(out_len)
    return Geometry(lane_in, n, plan.used, wq, mq, out_len, rows, tiles,
                    tile, s, pow(n % s, -1, s) if s > 1 else 0, len(pat),
                    sum(1 << i for i, k in enumerate(pat) if k))


def identity_geometry(N: int, bits: int) -> Geometry:
    """soft_llr's geometry: one row of the N * bits LLRs in wire order."""
    n = N * bits
    tiles, tile = _tiles(n)
    return Geometry(N, n, n, n, 0, n, 1, tiles, tile, 1, 0, 1, 1)


def _prefix(period: int, pattern: int) -> np.ndarray:
    """[period] kept positions before each position of a puncture period."""
    return np.array([bin(pattern & ((1 << i) - 1)).count("1")
                     for i in range(period)], np.int64)


def _kept_before(q, period: int, pattern: int):
    """Kept positions before mother-coded positions q >= 0."""
    per = q // period
    return (per * bin(pattern).count("1")
            + _prefix(period, pattern)[q - per * period])


def rows_emulation(g: Geometry, bits: int = 0, rows=None) -> np.ndarray:
    """The kernel's index plan replayed on the CPU for rows ``rows`` (a
    range; default all) of one lane: [len(rows), out_len] int64, each
    float's wire LLR index, -1 for a pad, -2 for a puncture zero.  Follows
    csrc/soft_llr.cu block by block and thread by thread: the tile's q and
    kept ranges, each residue's run (first element, offset, length, first
    slot), the items (an element of ``bits`` LLRs, or one LLR with bits=0:
    the LLR-input instance) walked r-major THREADS apart, the stage, then
    each thread's strided, incrementally advanced output positions.
    Raises RuntimeError if a stage slot is written other than once or a
    float reads a slot no item wrote."""
    rows = np.arange(g.rows) if rows is None else np.asarray(rows)
    w = np.repeat(rows.astype(np.int64), g.tiles)
    z = np.tile(np.arange(g.tiles, dtype=np.int64), rows.size)
    nb, B, s = w.size, max(bits, 1), g.stride
    o0 = z * g.tile
    length = np.minimum(g.tile, g.out_len - o0)
    qt = w * g.wq - g.mq + o0
    tv0 = np.clip(-qt, 0, length)
    tv1 = np.clip(g.used - qt, tv0, length)
    q0 = qt + tv0
    k0 = _kept_before(q0, g.period, g.pattern)
    k1 = _kept_before(qt + tv1, g.period, g.pattern)
    # the residues' runs, [blocks, s]
    r_ = np.arange(s, dtype=np.int64)[None, :]
    c = (np.zeros_like(r_) if s == 1
         else (r_ + ((s - r_) % s) * g.ninv % s * g.n) // s)
    a_lo = (k0[:, None] - r_ + s - 1) // s
    a_hi = np.maximum((k1[:, None] - r_ + s - 1) // s, a_lo)
    lo = a_lo + c
    phi = lo % B
    run = a_hi - a_lo
    first = s * a_lo + r_ - k0[:, None]
    # the items, thread by thread
    per_run = (k1 - k0 + s - 1) // s
    slots = (per_run + 2 * B - 2) // B
    items = np.where(k1 > k0, s * slots, 0)
    one = np.maximum(slots, 1)[:, None]
    tid = np.arange(THREADS)[None, :]
    r, m, i = tid // one, tid % one, np.broadcast_to(tid, (nb, THREADS))
    step_r, step_m = THREADS // one, THREADS % one
    stage = np.full((nb, g.tile), -3, np.int64)
    writes = np.zeros((nb, g.tile), np.int64)
    blk = np.broadcast_to(np.arange(nb)[:, None], (nb, THREADS))
    while True:
        live = i < items[:, None]
        if not live.any():
            break
        b_, r_l, m_l = blk[live], r[live], m[live]
        t0 = m_l * B - phi[b_, r_l]
        for b in range(B):
            t = t0 + b
            ok = (t >= 0) & (t < run[b_, r_l])
            slot = first[b_, r_l] + s * t
            stage[b_[ok], slot[ok]] = (lo[b_, r_l] + t)[ok]
            np.add.at(writes, (b_[ok], slot[ok]), 1)
        i = i + THREADS
        r = r + step_r
        m = m + step_m
        wrap = m >= one
        m = np.where(wrap, m - one, m)
        r = np.where(wrap, r + 1, r)
    K = k1 - k0
    inside = np.arange(g.tile)[None, :] < K[:, None]
    if (writes[inside] != 1).any() or (writes[~inside] != 0).any():
        raise RuntimeError("soft_llr_rows: the plan writes a stage slot "
                           "other than once")
    out = np.full((nb, g.tile), -1, np.int64)
    P, kp = g.period, bin(g.pattern).count("1")
    pre = _prefix(P, g.pattern)
    ph0 = q0 % P
    pre0 = pre[ph0]
    d = np.broadcast_to(np.arange(THREADS), (nb, THREADS)).copy()
    per = (ph0[:, None] + d) // P
    ph = (ph0[:, None] + d) - per * P
    step_per, step_ph = THREADS // P, THREADS % P
    valid = (tv1 - tv0)[:, None]
    while True:
        live = d < valid
        if not live.any():
            break
        b_ = np.nonzero(live)[0]
        keep = (g.pattern >> ph[live]) & 1
        src = stage[b_, np.where(keep == 1, per[live] * kp + pre[ph[live]]
                                 - pre0[b_], 0)]
        out[b_, tv0[b_] + d[live]] = np.where(keep == 1, src, -2)
        d += THREADS
        per += step_per
        ph += step_ph
        wrap = ph >= P
        ph[wrap] -= P
        per[wrap] += 1
    if (out == -3).any():
        raise RuntimeError("soft_llr_rows: a float reads a stage slot no "
                           "item wrote")
    # the tiles of a row, end to end
    return np.concatenate(
        [out[i * g.tiles + t, :length[i * g.tiles + t]]
         for i in range(rows.size) for t in range(g.tiles)]
    ).reshape(rows.size, g.out_len)


@functools.lru_cache(maxsize=None)
def _kernel_fn():
    from rub_mimo_tpu_torch.kernels import _build

    fn = _build.load("soft_llr").soft_llr_rows
    P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    fn.argtypes = [P, I, I, P, P, I, F, P, I, P, F, P, P]
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


def _launch(x: torch.Tensor, lanes: int, g: Geometry, pts, bits: int,
            noise_var, out: torch.Tensor, pad: float) -> None:
    """One launch of csrc/soft_llr.cu; raises on a refused launch."""
    llr_input = x.dtype == torch.float32
    value, nv, reciprocal = ((0.0, None, 1) if llr_input
                             else _noise_var_arg(noise_var, x.device))
    geom = (ctypes.c_longlong * len(g))(*g)
    with torch.cuda.device(x.device):
        err = _kernel_fn()(
            x.data_ptr(), int(llr_input), lanes,
            None if llr_input else pts.ctypes.data,
            None if llr_input else _points_on(pts.tobytes(),
                                              x.device).data_ptr(),
            bits, value, None if nv is None else nv.data_ptr(), reciprocal,
            geom, pad, out.data_ptr(),
            torch.cuda.current_stream(x.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"soft_llr kernel launch failed: CUDA error {err}")


def soft_llr(y: torch.Tensor, points,
             noise_var: float | torch.Tensor = 1.0) -> torch.Tensor:
    """``soft_llr_plain``'s LLRs [..., bits] float32: the kernel with the
    identity geometry on a CUDA tensor (one launch for every symbol), the
    plain version on a CPU tensor."""
    if y.dtype != torch.complex64:
        raise ValueError(f"soft_llr: y must be complex64, got {y.dtype}")
    pts = _points(points)
    bits = _bits_of(pts)
    if y.device.type == "cpu":
        return soft_llr_plain(y, pts, noise_var)
    if y.device.type != "cuda":
        raise ValueError(f"soft_llr: no kernel for {y.device}")
    n = y.numel()
    out = torch.empty((n, bits), dtype=torch.float32, device=y.device)
    if n == 0:
        return out.reshape(*y.shape, bits)
    if n >= 1 << 37:
        raise ValueError(f"soft_llr: {n} symbols too many for the kernel")
    _launch(y.reshape(-1).contiguous(), 1, identity_geometry(n, bits), pts,
            bits, noise_var, out, 0.0)
    soft_llr.launches += 1
    return out.reshape(*y.shape, bits)


soft_llr.launches = 0


@device_constant
def _pinned(rows: int, pinned: bool, device: torch.device) -> torch.Tensor:
    """[rows] bool, all ``pinned``: shared by every call with these rows
    (the Viterbi only reads it)."""
    return torch.full((rows,), pinned, dtype=torch.bool, device=device)


def soft_llr_rows(x: torch.Tensor, plan: RowPlan, points=None,
                  noise_var: float | torch.Tensor = 1.0):
    """``soft_llr_rows_plain``'s (pairs, pinned) of x (complex64 symbols
    [lanes, N] over ``points``, or float32 wire LLRs [lanes, n]): one
    launch of the kernel on a CUDA tensor, the plain version on a CPU
    tensor.  On CUDA ``pinned`` is a cached tensor shared between calls:
    read it, do not write it."""
    llr_input = x.dtype == torch.float32
    if not llr_input and x.dtype != torch.complex64:
        raise ValueError("soft_llr_rows: x must be complex64 symbols or "
                         f"float32 LLRs, got {x.dtype}")
    if x.dim() != 2 or x.shape[0] < 1:
        raise ValueError("soft_llr_rows: x must be [lanes, width], got "
                         f"{tuple(x.shape)}")
    pts, bits = None, 1
    if not llr_input:
        pts = _points(points)
        bits = _bits_of(pts)
    elif points is not None:
        raise ValueError("soft_llr_rows: LLR input takes no points")
    if x.device.type == "cpu":
        return soft_llr_rows_plain(x, plan, pts, noise_var)
    if x.device.type != "cuda":
        raise ValueError(f"soft_llr_rows: no kernel for {x.device}")
    from rub_mimo_tpu_torch.ofdm import fec

    L, width = x.shape
    g = row_geometry(plan, width * (1 if llr_input else bits), width)
    out = torch.empty((L * g.rows, g.out_len // 2, 2), dtype=torch.float32,
                      device=x.device)
    _launch(x.contiguous(), L, g, pts, bits, noise_var, out, fec._PAD_LLR)
    soft_llr_rows.launches += 1
    return out, _pinned(L * g.rows, plan.window is None, x.device)


soft_llr_rows.launches = 0
