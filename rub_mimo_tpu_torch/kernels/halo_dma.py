"""Halo exchange to the right neighbour along the mesh's "time" axis (K8).

Port of rub_mimo_tpu/kernels/halo_dma.py::ring_shift_right.  The sharded
decode's full-rate sync (parallel.decode_sharded, ``halo_impl=
"pallas_dma"``) needs each time shard's last M-1 samples at its right
neighbour, as the overlap-save halo of the S&C correlator.  On CUDA
tensors ``ring_shift_right`` launches the hand-written Hopper kernel
csrc/halo_dma.cu once per exchange, with every shard's source and
destination pointer passed by value in the kernel's parameter struct;
on CPU tensors it runs ``ring_shift_right_reference``, the plain list
shift that the tests and chip_smoke.py hold the kernel against.  There
is no fallback: a CUDA call that the kernel cannot take raises.

The kernel needs every shard on one device (a mesh of logical shards on
one card).  The peer-to-peer form for shards on several cards is not
written: such a mesh raises ValueError, and takes the "ppermute"
collective (parallel.collectives) instead.
"""

from __future__ import annotations

import ctypes
import functools

import torch

MAX_SHARDS = 64  # the kernel's parameter struct holds this many pointers


class _Params(ctypes.Structure):
    """csrc/halo_dma.cu's HaloParams, field for field."""

    _fields_ = [("src", ctypes.c_void_p * MAX_SHARDS),
                ("dst", ctypes.c_void_p * MAX_SHARDS),
                ("src_row_stride", ctypes.c_longlong),
                ("rows", ctypes.c_int),
                ("len", ctypes.c_int),
                ("n_time", ctypes.c_int),
                ("n_sc", ctypes.c_int)]


def _grid(parts, mesh):
    n_time, n_sc = mesh.shape["time"], mesh.shape["sc"]
    if len(parts) != n_time or any(len(row) != n_sc for row in parts):
        raise ValueError(f"ring_shift_right: parts must be [{n_time}][{n_sc}] "
                         "per-shard tensors, one per mesh shard")
    return n_time, n_sc


def ring_shift_right_reference(parts, mesh):
    """Plain version: shard (t, s) gets shard (t-1, s)'s tensor, shard
    (0, s) zeros of its own shape (ppermute's zero fill of an absent
    peer)."""
    n_time, n_sc = _grid(parts, mesh)
    return [[torch.zeros_like(parts[t][s]) if t == 0 else parts[t - 1][s]
             for s in range(n_sc)] for t in range(n_time)]


@functools.lru_cache(maxsize=None)
def _kernel_fn():
    from rub_mimo_tpu_torch.kernels import _build

    fn = _build.load("halo_dma").ring_shift_right
    fn.argtypes = [ctypes.POINTER(_Params), ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _check(flat) -> None:
    x0 = flat[0]
    for x in flat:
        if x.dtype != torch.complex64:
            raise ValueError(f"ring_shift_right: halos must be complex64, "
                             f"got {x.dtype}")
        if x.dim() != 2 or tuple(x.shape) != tuple(x0.shape):
            raise ValueError("ring_shift_right: halos must be [S, H], all "
                             f"of one shape; got {tuple(x.shape)} and "
                             f"{tuple(x0.shape)}")
        if x.shape[0] > 1 and (x.stride() != x0.stride()
                               or x.stride(0) < x.shape[1]):
            raise ValueError("ring_shift_right: halos must share their row "
                             "stride")
        if x.shape[1] > 1 and x.stride(1) != 1:
            raise ValueError("ring_shift_right: halo rows must be "
                             "contiguous")
    if min(x0.shape) < 1 or x0.numel() >= 1 << 31:
        raise ValueError(f"ring_shift_right: halo shape {tuple(x0.shape)} "
                         "out of range")


def ring_shift_right(parts, mesh):
    """parts[t][s]: shard (t, s)'s complex64 [S, H] halo (rows may be a
    strided view, e.g. ``local[:, -H:]``).  Returns the per-shard
    [S, H] halos received: shard (t-1, s)'s for t > 0, zeros for t = 0."""
    n_time, n_sc = _grid(parts, mesh)
    flat = [x for row in parts for x in row]
    devices = {x.device for x in flat}
    if devices == {torch.device("cpu")}:
        return ring_shift_right_reference(parts, mesh)
    if len(devices) != 1:
        raise ValueError("ring_shift_right: the kernel needs every shard on "
                         f"one device, got {sorted(map(str, devices))}; use "
                         "the ppermute collective across devices")
    dev = flat[0].device
    if dev.type != "cuda":
        raise ValueError(f"ring_shift_right: no kernel for {dev}")
    n = n_time * n_sc
    if n > MAX_SHARDS:
        raise ValueError(f"ring_shift_right: {n} shards, the kernel takes at "
                         f"most {MAX_SHARDS}")
    _check(flat)
    S, H = flat[0].shape
    out = torch.empty((n, S, H), dtype=torch.complex64, device=dev)
    p = _Params()
    for i, x in enumerate(flat):
        p.src[i] = x.data_ptr()
        p.dst[i] = out[i].data_ptr()
    p.src_row_stride = max(flat[0].stride(0), H)
    p.rows, p.len, p.n_time, p.n_sc = S, H, n_time, n_sc
    with torch.cuda.device(dev):
        err = _kernel_fn()(ctypes.byref(p),
                           torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"ring_shift_right kernel launch failed: CUDA "
                           f"error {err}")
    ring_shift_right.launches += 1
    return [[out[t * n_sc + s] for s in range(n_sc)] for t in range(n_time)]


ring_shift_right.launches = 0
