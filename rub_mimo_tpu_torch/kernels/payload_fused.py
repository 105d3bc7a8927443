"""Fused payload tails: FFT + ZF/MMSE equalize + hard demap, with (K1) or
without (K2) the CP strip.

Ports of rub_mimo_tpu/kernels/payload_fused.py::payload_fused_strip (K1)
and ::payload_fused (K2).  On CUDA tensors ``payload_fused_strip`` and
``payload_fused`` launch the hand-written Hopper kernels
csrc/payload_fused_strip.cu and csrc/payload_fused.cu (a persistent,
occupancy-sized grid; cp.async copies of the next frame overlapping the
transform; a Stockham FFT of radix-16 register passes, ``fft_plan``; the
demap points by value, ``pack_points``; the block shared through
csrc/payload_fft.cuh, see the source notes); on CPU tensors they run
``payload_tail_reference`` and ``payload_fused_reference``, the plain
PyTorch versions of the same math that the tests and chip_smoke.py hold
the kernels against.  There is no fallback: a CUDA call that a kernel
cannot take, or whose build or launch fails, raises.

Outputs are [S, n_sym, M] in natural subcarrier order with exactly n_sym
frames; the JAX kernel's packed order and pad frames were TPU tile
artifacts.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional

import numpy as np
import torch

from rub_mimo_tpu_torch.detect import zf
from rub_mimo_tpu_torch.ofdm import constellation
from rub_mimo_tpu_torch.utils import gather
from rub_mimo_tpu_torch.utils.device_cache import device_constant

MAX_POINTS = 64


def strip_supported(M: int, n_streams: int, arity: int) -> bool:
    """Geometry gate of the K1 and K2 kernels: M a power of two in
    [64, 4096], 1..4 streams, at most 64 points.  The kernels equalize and
    demap every subcarrier, so the caller's allocation must be
    all-occupied."""
    return (64 <= M <= 4096 and M & (M - 1) == 0
            and 1 <= n_streams <= 4 and arity <= MAX_POINTS)


def fft_plan(M: int) -> tuple:
    """The radices of the K1/K2 FFT of M points, in pass order: radix 16
    while four or more radix-2 stages are left, then the rest
    (2048 -> (16, 16, 8), 64 -> (16, 4)).  The wrappers hand this plan to
    the kernels, which check that it multiplies to M."""
    if M < 16 or M & (M - 1):
        raise ValueError(f"fft_plan: M={M} is not a power of two >= 16")
    m = M.bit_length() - 1
    return (16,) * (m // 4) + ((1 << (m % 4),) if m % 4 else ())


def twiddle_table(M: int) -> np.ndarray:
    """exp(-2 pi i m / M), m < M: float64, rounded once to complex64."""
    return np.exp(-2j * np.pi * np.arange(M) / M).astype(np.complex64)


def pass_twiddles(M: int) -> np.ndarray:
    """The twiddles the kernels read: for each pass of ``fft_plan(M)``
    after the first (radix R after radices of product Ns), the [R, Ns]
    block tw[r, k] = twiddle_table(M)[r k M / (Ns R)], concatenated.  The
    same float32 values as the table, laid out so that the lanes of a
    warp (adjacent k) read adjacent entries."""
    tw = twiddle_table(M)
    plan = fft_plan(M)
    blocks, Ns = [], plan[0]
    for R in plan[1:]:
        r, k = np.arange(R)[:, None], np.arange(Ns)[None, :]
        blocks.append(tw[r * k * (M // (Ns * R))].ravel())
        Ns *= R
    return (np.concatenate(blocks) if blocks
            else np.zeros(0, np.complex64))


def _dft_matrix(R: int, device) -> torch.Tensor:
    """[R, R] complex64, exp(-2 pi i r q / R) built in float64."""
    r = np.arange(R)
    return torch.as_tensor(np.exp(-2j * np.pi * np.outer(r, r) / R)
                           .astype(np.complex64), device=device)


def stockham_fft(x: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of the kernels' FFT over the last axis (the
    plan ``fft_plan(M)``), pass by pass with the kernels' index maps and
    twiddles (``pass_twiddles``): the pass of radix R after radices of
    product Ns reads v[j, r] = x[j + r M/R] * tw_p[r, j mod Ns] (no
    twiddles in the first pass), takes y[j] = DFT_R(v[j]) and writes
    x'[(j - j mod Ns) R + j mod Ns + q Ns] = y[j, q].  The last pass
    leaves the DFT in natural order."""
    M = x.shape[-1]
    plan = fft_plan(M)
    dev = x.device
    tw = torch.as_tensor(pass_twiddles(M), device=dev)
    x = x.to(torch.complex64)
    Ns, off = 1, 0
    for R in plan:
        j = torch.arange(M // R, device=dev)[:, None]
        r = torch.arange(R, device=dev)[None, :]
        k = j % Ns
        v = x[..., j + r * (M // R)]
        if Ns > 1:
            v = v * tw[off + r * Ns + k]
            off += R * Ns
        out = torch.empty_like(x)
        out[..., (j - k) * R + k + r * Ns] = v @ _dft_matrix(R, dev)
        x, Ns = out, Ns * R
    return x


def pack_points(table: np.ndarray) -> np.ndarray:
    """The demap points as the K1/K2 parameter struct holds them: [3, 64]
    float32 rows (Re c, Im c, |c|^2 / 2), constellation.demap_planes's
    values in table order, zeros past the last point (768 bytes)."""
    planes = constellation.demap_planes(table)
    if planes.shape[1] > MAX_POINTS:
        raise ValueError(f"{planes.shape[1]} points: the kernels take at "
                         f"most {MAX_POINTS}")
    out = np.zeros((3, MAX_POINTS), np.float32)
    out[:, :planes.shape[1]] = planes
    return out


@functools.lru_cache(maxsize=16)
def _host_points(table_bytes: bytes) -> np.ndarray:
    return pack_points(np.frombuffer(table_bytes, dtype=np.complex64))


@functools.lru_cache(maxsize=16)
def _host_plan(M: int):
    plan = fft_plan(M)
    return (ctypes.c_int * len(plan))(*plan), len(plan)


def payload_tail_reference(p_re: torch.Tensor, p_im: torch.Tensor,
                           W: torch.Tensor, gain: torch.Tensor,
                           table: np.ndarray, dft_norm: float, *,
                           n_sym: int, symbol_len: int, cp_len: int,
                           M: Optional[int] = None, emit_sig: bool = True,
                           start=None):
    """Plain PyTorch payload tail: with a ``start``, the window
    (``utils.gather.gather_window``) first; then reshape-strip the CPs
    (the M samples after each CP), torch.fft.fft, scale by dft_norm,
    detect.zf.equalize, hard demap over ``table``.  Same arguments and
    results as ``payload_fused_strip``."""
    S = p_re.shape[0]
    M = symbol_len - cp_len if M is None else M
    if start is not None:
        win = gather.window_index(start, n_sym * symbol_len,
                                  p_re.shape[-1], p_re.device)
        p_re, p_im = (gather.gather_window(p, win) for p in (p_re, p_im))
    x = torch.complex(p_re, p_im)[:, : n_sym * symbol_len]
    x = x.reshape(S, n_sym, symbol_len)[:, :, cp_len:cp_len + M]
    X = torch.fft.fft(x, dim=-1) * float(dft_norm)
    eq = zf.equalize(X.transpose(0, 1), W, gain).transpose(0, 1)
    rx_data = constellation.hard_demap(eq, table)
    return (eq.contiguous() if emit_sig else None), rx_data


@functools.lru_cache(maxsize=None)
def _kernel_fn():
    from rub_mimo_tpu_torch.kernels import _build

    fn = _build.load("payload_fused_strip").payload_fused_strip
    P, I = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = [P, P, ctypes.c_longlong, P, P, P, P, I, P, I, P,
                   ctypes.c_float, I, I, I, I, I, I, P, P, P]
    fn.restype = I
    return fn


@functools.lru_cache(maxsize=None)
def _geometry_fn(kernel: str):
    from rub_mimo_tpu_torch.kernels import _build

    fn = getattr(_build.load(kernel), f"{kernel}_geometry")
    P, I = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = [I, I, I, I, P, I, P]
    fn.restype = I
    return fn


def launch_geometry(kernel: str, S: int, M: int, n_sym: int,
                    device=None) -> dict:
    """The launch K1 (``kernel="payload_fused_strip"``) or K2
    (``"payload_fused"``) makes for S streams, M points and n_sym frames on
    a CUDA device: grid = min(n_sym, blocks per SM x SMs), the blocks per
    SM from the CUDA occupancy calculator, threads per block, dynamic
    shared bytes and whether the block double-buffers its copies."""
    if kernel not in ("payload_fused_strip", "payload_fused"):
        raise ValueError(f"launch_geometry: unknown kernel {kernel!r}")
    if not strip_supported(M, S, 1) or n_sym < 1:
        raise ValueError(f"launch_geometry: no launch for S={S}, M={M}, "
                         f"n_sym={n_sym}")
    plan, n_pass = _host_plan(M)
    geo = (ctypes.c_int * 6)()
    with torch.cuda.device(device):
        err = _geometry_fn(kernel)(S, M, M.bit_length() - 1, n_sym, plan,
                                   n_pass, geo)
    if err != 0:
        raise RuntimeError(f"{kernel} geometry failed: CUDA error {err}")
    return dict(zip(("grid", "blocks_per_sm", "sms", "threads",
                     "smem_bytes", "two_stage"), list(geo)))


@device_constant
def _twiddles(M: int, device: torch.device) -> torch.Tensor:
    """``pass_twiddles(M)`` on ``device`` (at least one entry)."""
    tw = pass_twiddles(M)
    return torch.as_tensor(tw if tw.size else np.ones(1, np.complex64),
                           device=device)


def _check(p_re, p_im, W, gain, table, n_sym, symbol_len, cp_len, M=None,
           start=None):
    S = p_re.shape[0]
    M = symbol_len - cp_len if M is None else M
    plane = (S, n_sym * symbol_len if start is None else p_re.shape[-1])
    if start is not None and not (
            isinstance(start, torch.Tensor) and start.dtype == torch.int64
            and start.numel() == 1 and start.device == p_re.device):
        raise ValueError("start must be a one-element int64 tensor on the "
                         "planes' device")
    for name, t, dt, shape in (
        ("p_re", p_re, torch.float32, plane),
        ("p_im", p_im, torch.float32, plane),
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
    if n_sym < 1 or cp_len < 0 or symbol_len < M + cp_len:
        raise ValueError("need n_sym >= 1, cp_len >= 0 and symbol_len >= "
                         f"M + cp_len, got {n_sym}, {cp_len}, {symbol_len}, "
                         f"M={M}")
    if not strip_supported(M, S, len(table)):
        raise ValueError(
            f"payload_fused_strip kernel does not take M={M}, S={S}, "
            f"{len(table)} points (see strip_supported)")


def payload_fused_strip(p_re: torch.Tensor, p_im: torch.Tensor,
                        W: torch.Tensor, gain: torch.Tensor,
                        table: np.ndarray, dft_norm: float, *,
                        n_sym: int, symbol_len: int, cp_len: int,
                        M: Optional[int] = None, emit_sig: bool = True,
                        start=None):
    """Payload tail over the flat payload planes, or over a window of a
    whole capture's planes.

    p_re, p_im: [S, n_sym*symbol_len] float32, CPs in place (what
    pipeline.rx.extract_payload gives), or with ``start`` a capture's
    [S, T] planes; W: [M, out, rx] complex64; gain: [M] float32; table:
    constellation points (numpy); dft_norm: 1/sqrt(M_occupied).  Symbol
    k's M samples start at start + k*symbol_len + cp_len (start 0 when
    None); positions outside [0, T) read as zeros (the window
    ``utils.gather.gather_window`` reads).  ``start`` is a one-element
    int64 tensor on the planes' device, never read on the host, so the
    call can be captured in a CUDA graph and replayed at another start.
    M defaults to symbol_len - cp_len, and a larger pitch (symbol_len >
    M + cp_len) skips the samples between symbols (the sharded decode's
    stripe of every n_sc-th symbol).

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
            symbol_len=symbol_len, cp_len=cp_len, M=M, emit_sig=emit_sig,
            start=start)
    if p_re.device.type != "cuda":
        raise ValueError(f"payload_fused_strip: no kernel for {p_re.device}")
    M = symbol_len - cp_len if M is None else M
    _check(p_re, p_im, W, gain, table, n_sym, symbol_len, cp_len, M, start)
    dev = p_re.device
    S = p_re.shape[0]
    fn = _kernel_fn()
    points = _host_points(np.asarray(table, np.complex64).tobytes())
    plan, n_pass = _host_plan(M)
    twiddle = _twiddles(M, dev)
    rx_data = torch.empty((S, n_sym, M), dtype=torch.int32, device=dev)
    rx_sig = (torch.empty((S, n_sym, M), dtype=torch.complex64, device=dev)
              if emit_sig else None)
    with torch.cuda.device(dev):
        err = fn(p_re.data_ptr(), p_im.data_ptr(), p_re.shape[1],
                 None if start is None else start.data_ptr(),
                 W.data_ptr(), gain.data_ptr(), points.ctypes.data,
                 len(table), plan, n_pass, twiddle.data_ptr(),
                 float(dft_norm), S, M, M.bit_length() - 1, n_sym,
                 symbol_len, cp_len,
                 rx_data.data_ptr(),
                 None if rx_sig is None else rx_sig.data_ptr(),
                 torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(
            f"payload_fused_strip kernel launch failed: CUDA error {err}")
    payload_fused_strip.launches += 1
    payload_fused_strip.windowed += start is not None
    return rx_sig, rx_data


payload_fused_strip.launches = 0
payload_fused_strip.windowed = 0  # launches that read a capture's window


def payload_fused_reference(x_t: torch.Tensor, W: torch.Tensor,
                            gain: torch.Tensor, table: np.ndarray,
                            dft_norm: float, emit_sig: bool = True):
    """Plain PyTorch version of ``payload_fused``: torch.fft.fft, then
    detect.zf.equalize with the gain scaled by dft_norm, then the hard
    demap over ``table``."""
    X = torch.fft.fft(x_t, dim=-1)
    g = gain * float(dft_norm)
    eq = zf.equalize(X.transpose(0, 1), W, g).transpose(0, 1)
    rx_data = constellation.hard_demap(eq, table)
    return (eq.contiguous() if emit_sig else None), rx_data


@functools.lru_cache(maxsize=None)
def _k2_fn():
    from rub_mimo_tpu_torch.kernels import _build

    fn = _build.load("payload_fused").payload_fused
    P, I = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = [P, P, P, P, I, P, I, P, ctypes.c_float, I, I, I, I, P, P,
                   P]
    fn.restype = I
    return fn


def payload_fused(x_t: torch.Tensor, W: torch.Tensor, gain: torch.Tensor,
                  table: np.ndarray, dft_norm: float, emit_sig: bool = True):
    """Payload tail over CP-stripped symbols (K2).

    x_t: [S, n_sym, M] complex64 (what kernels.cp_strip gives); W:
    [M, out, rx] complex64; gain: [M] float32; table: constellation
    points (numpy); dft_norm: 1/sqrt(M_occupied), folded into the gain.

    Returns (rx_sig [S, n_sym, M] complex64 | None, rx_data [S, n_sym, M]
    int32), natural order, with
    eq[o, k, sc] = (sum_j W[sc, o, j] X[j, k, sc]) * (gain[sc] * dft_norm),
    X = DFT_M(x_t), demapped nearest-neighbour."""
    devices = {t.device for t in (x_t, W, gain)}
    if len(devices) != 1:
        raise ValueError("payload_fused: inputs on several devices "
                         f"{sorted(map(str, devices))}")
    if x_t.device.type == "cpu":
        return payload_fused_reference(x_t, W, gain, table, dft_norm,
                                       emit_sig)
    if x_t.device.type != "cuda":
        raise ValueError(f"payload_fused: no kernel for {x_t.device}")
    if x_t.dim() != 3:
        raise ValueError("payload_fused: x_t must be [S, n_sym, M], got "
                         f"{tuple(x_t.shape)}")
    S, n_sym, M = x_t.shape
    for name, t, dt, shape in (
        ("x_t", x_t, torch.complex64, (S, n_sym, M)),
        ("W", W, torch.complex64, (M, S, S)),
        ("gain", gain, torch.float32, (M,)),
    ):
        if t.dtype != dt:
            raise ValueError(f"payload_fused: {name} must be {dt}, got "
                             f"{t.dtype}")
        if tuple(t.shape) != shape:
            raise ValueError(f"payload_fused: {name} must have shape "
                             f"{shape}, got {tuple(t.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"payload_fused: {name} must be contiguous")
    if n_sym < 1 or not strip_supported(M, S, len(table)):
        raise ValueError(f"payload_fused kernel does not take M={M}, S={S}, "
                         f"n_sym={n_sym}, {len(table)} points "
                         "(see strip_supported)")
    dev = x_t.device
    points = _host_points(np.asarray(table, np.complex64).tobytes())
    plan, n_pass = _host_plan(M)
    twiddle = _twiddles(M, dev)
    rx_data = torch.empty((S, n_sym, M), dtype=torch.int32, device=dev)
    rx_sig = (torch.empty((S, n_sym, M), dtype=torch.complex64, device=dev)
              if emit_sig else None)
    with torch.cuda.device(dev):
        err = _k2_fn()(x_t.data_ptr(), W.data_ptr(), gain.data_ptr(),
                       points.ctypes.data, len(table), plan, n_pass,
                       twiddle.data_ptr(), float(dft_norm), S, M,
                       M.bit_length() - 1, n_sym,
                       rx_data.data_ptr(),
                       None if rx_sig is None else rx_sig.data_ptr(),
                       torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(
            f"payload_fused kernel launch failed: CUDA error {err}")
    payload_fused.launches += 1
    return rx_sig, rx_data


payload_fused.launches = 0
