"""Halo exchange to the right neighbour along the mesh's "time" axis (K8).

Port of rub_mimo_tpu/kernels/halo_dma.py::ring_shift_right.  The sharded
decode's full-rate sync (parallel.decode_sharded, ``halo_impl=
"pallas_dma"``) needs each time shard's last M-1 samples at its right
neighbour, as the overlap-save halo of the S&C correlator.  On CUDA
tensors ``ring_shift_right`` launches the hand-written Hopper kernel
csrc/halo_dma.cu, with the source and destination pointers passed by
value in the kernel's parameter struct; on CPU tensors it runs
``ring_shift_right_reference``, the plain list shift that the tests and
chip_smoke.py hold the kernel against.  There is no fallback: a CUDA call
that the kernel cannot take raises.

The shards may sit on one card (logical shards) or on several.  Each
destination pulls its halo from its left neighbour's buffer, so the
exchange is one launch per card that holds a destination shard
(``plan_launches``), on that card's current stream; a source on another
card is read over NVLink through its own pointer, after peer access from
the destination card to the source card is enabled (``peer_pairs``).
The TPU kernel's symmetric push, its wait for its own send and receive
and the masking of its wrap-around copy are not carried over.

Across processes (a mesh over several ranks, parallel.mesh) the kernel
is the same and pulls through a pointer into the left neighbour rank's
memory: ``ProcessHalo`` (one rank a card under NCCL, or several ranks on
one card under gloo).
"""

from __future__ import annotations

import ctypes
import functools

import torch

MAX_SHARDS = 64  # the kernel's parameter struct holds this many pointers
# cudaErrorPeerAccessUnsupported, what csrc/halo_dma.cu's
# enable_peer_access returns where cudaDeviceCanAccessPeer says no
_PEER_UNSUPPORTED = 217


class _Params(ctypes.Structure):
    """csrc/halo_dma.cu's HaloParams, field for field."""

    _fields_ = [("src", ctypes.c_void_p * MAX_SHARDS),
                ("dst", ctypes.c_void_p * MAX_SHARDS),
                ("src_row_stride", ctypes.c_longlong),
                ("rows", ctypes.c_int),
                ("len", ctypes.c_int),
                ("n_dst", ctypes.c_int)]


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


def plan_launches(devices) -> list:
    """The kernel's launches for shards on ``devices``, a [n_time][n_sc]
    grid of torch.device (a Mesh's ``devices``, or the halos' own): one
    (device, [(t, s), ...]) per device that holds a shard, in time-major
    order of first appearance.  Every shard is a destination (those of
    t = 0 receive zeros), so a mesh on one card is one launch and a mesh
    over k cards k launches."""
    groups: dict = {}
    for t, row in enumerate(devices):
        for s, d in enumerate(row):
            groups.setdefault(torch.device(d), []).append((t, s))
    return list(groups.items())


def peer_pairs(devices) -> list:
    """The (destination device, source device) pairs whose peer access
    the exchange needs: shard (t, s) reads shard (t-1, s)'s halo, for
    t >= 1, where the two devices differ; each pair once, in time-major
    order of first appearance."""
    pairs: dict = {}
    for t in range(1, len(devices)):
        for s, d in enumerate(devices[t]):
            dst, src = torch.device(d), torch.device(devices[t - 1][s])
            if dst != src:
                pairs.setdefault((dst, src), None)
    return list(pairs)


@functools.lru_cache(maxsize=None)
def _lib():
    from rub_mimo_tpu_torch.kernels import _build

    lib = _build.load("halo_dma")
    lib.ring_shift_right.argtypes = [ctypes.POINTER(_Params), ctypes.c_void_p]
    lib.ring_shift_right.restype = ctypes.c_int
    lib.enable_peer_access.argtypes = [ctypes.c_int, ctypes.c_int]
    lib.enable_peer_access.restype = ctypes.c_int
    lib.ipc_export.argtypes = [ctypes.c_int, ctypes.c_void_p,
                               ctypes.c_char_p,
                               ctypes.POINTER(ctypes.c_longlong)]
    lib.ipc_open.argtypes = [ctypes.c_int, ctypes.c_char_p,
                             ctypes.POINTER(ctypes.c_void_p)]
    lib.ipc_close.argtypes = [ctypes.c_int, ctypes.c_void_p]
    for fn in (lib.ipc_export, lib.ipc_open, lib.ipc_close):
        fn.restype = ctypes.c_int
    return lib


@functools.lru_cache(maxsize=None)
def _peer_access(device: int, peer: int) -> int:
    """enable_peer_access's result for (card, peer), asked once."""
    return _lib().enable_peer_access(device, peer)


def _enable_peer(dst: torch.device, src: torch.device) -> None:
    """Where trouble is likely (1), peer access: the destination card's
    kernel reads the source card's memory, which needs peer access from
    dst to src.  Enabled once per pair; a pair the hardware cannot join
    raises, with no other route."""
    err = _peer_access(dst.index, src.index)
    if err == _PEER_UNSUPPORTED:
        raise ValueError(f"ring_shift_right: {dst} cannot access {src}'s "
                         "memory (cudaDeviceCanAccessPeer is 0); the kernel "
                         "reads a neighbour's halo through peer access")
    if err != 0:
        raise RuntimeError(f"ring_shift_right: enabling peer access from "
                           f"{dst} to {src} failed: CUDA error {err}")


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


def _event_on(stream) -> torch.cuda.Event:
    ev = torch.cuda.Event()
    ev.record(stream)
    return ev


def ring_shift_right(parts, mesh):
    """parts[t][s]: shard (t, s)'s complex64 [S, H] halo (rows may be a
    strided view, e.g. ``local[:, -H:]``), on its shard's device.
    Returns the per-shard [S, H] halos received, each on its shard's
    device: shard (t-1, s)'s for t > 0, zeros for t = 0.

    On CUDA tensors the kernel runs once per device that holds a shard
    (``plan_launches``), and ``ring_shift_right.launches`` counts those
    launches: any mesh on one card 1; a (4, 1) mesh on four cards 4 (card
    0's launch only writes zeros); a (2, 2) mesh's "sc" column 0 on cards
    0 and 2 (what the sharded decode's stage A exchanges) 2."""
    n_time, n_sc = _grid(parts, mesh)
    if getattr(mesh, "spans_processes", False):
        raise ValueError("ring_shift_right: the mesh spans processes; "
                         "its halos go through ProcessHalo")
    flat = [x for row in parts for x in row]
    devices = {x.device for x in flat}
    if devices == {torch.device("cpu")}:
        return ring_shift_right_reference(parts, mesh)
    if any(d.type != "cuda" for d in devices):
        if len(devices) == 1:
            raise ValueError(f"ring_shift_right: no kernel for "
                             f"{flat[0].device}")
        raise ValueError("ring_shift_right: the plain version needs every "
                         "shard on one device (the CPU), the kernel every "
                         f"shard on CUDA devices; got "
                         f"{sorted(map(str, devices))}")
    _check(flat)
    grid = [[x.device for x in row] for row in parts]
    plan = plan_launches(grid)
    for dev, shards in plan:
        if len(shards) > MAX_SHARDS:
            raise ValueError(f"ring_shift_right: {len(shards)} shards on "
                             f"{dev}, the kernel takes at most {MAX_SHARDS} "
                             "a card")
    for dst, src in peer_pairs(grid):
        _enable_peer(dst, src)
    S, H = flat[0].shape
    stride = max(flat[0].stride(0), H)
    out = [[None] * n_sc for _ in range(n_time)]
    for dev, shards in plan:
        # where trouble is likely (3), launch context: each launch runs
        # under its own card, on that card's current stream, and its
        # parameters hold only that card's destinations and their sources
        recv = torch.empty((len(shards), S, H), dtype=torch.complex64,
                           device=dev)
        p = _Params()
        p.src_row_stride, p.rows, p.len, p.n_dst = stride, S, H, len(shards)
        peers = {}
        for k, (t, s) in enumerate(shards):
            p.dst[k] = recv[k].data_ptr()
            out[t][s] = recv[k]
            if t > 0:
                src = parts[t - 1][s]
                p.src[k] = src.data_ptr()
                if src.device != dev:
                    peers.setdefault(src.device, None)
        stream = torch.cuda.current_stream(dev)
        with torch.cuda.device(dev):
            # where trouble is likely (2), ordering across cards: a source
            # halo is written on its own card's stream, so this card's
            # stream waits for that stream before the read ...
            for c in peers:
                stream.wait_event(_event_on(torch.cuda.current_stream(c)))
            err = _lib().ring_shift_right(ctypes.byref(p), stream.cuda_stream)
            if err != 0:
                raise RuntimeError(f"ring_shift_right kernel launch failed "
                                   f"on {dev}: CUDA error {err}")
            ring_shift_right.launches += 1
            # ... and the source card's stream waits for the read before
            # anything after it, so the caching allocator cannot hand the
            # source's memory to new work on that card while this card
            # still reads it (the TPU kernel's rdma.wait())
            if peers:
                done = _event_on(stream)
                for c in peers:
                    torch.cuda.current_stream(c).wait_event(done)
    return out


ring_shift_right.launches = 0


IPC_HANDLE_BYTES = 64  # cudaIpcMemHandle_t


def _ipc(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"ProcessHalo: {what} failed: CUDA error {err}")


class ProcessHalo:
    """K8 across processes, on a mesh over several ranks whose shards each
    rank holds on one CUDA device: ``halo(parts)`` is ring_shift_right of
    the ranks' [rows, length] complex64 halos, each rank passing and
    getting its own shards' (None elsewhere), with one launch a rank.

    At construction (every rank at once) each rank allocates the buffer
    its shards' halos are copied into, [its shards, rows, length], and
    exports it (``ipc_export``: the handle covers the caching allocator's
    whole block, so the byte offset goes with it); the handles go across
    once through the group, and each rank maps the buffer of every rank it
    reads from (``ipc_open``).  A call copies the local halos in, waits
    for its stream, meets every rank at a barrier (every buffer written),
    launches the kernel (a shard whose left neighbour is another rank's
    pulls through the mapped pointer, the others from this rank's own
    buffer), waits for it and meets them again (every read done, so a
    buffer may be overwritten): the host handshake that replaces the TPU
    kernel's send and receive semaphores.  ``close`` (every rank at once)
    unmaps, then meets the others before the buffers may be freed."""

    def __init__(self, mesh, rows: int, length: int):
        import torch.distributed as dist

        mine = mesh.local_shards()
        devices = {torch.device(mesh.devices[t, s]) for t, s in mine}
        dev = next(iter(devices))
        if len(devices) != 1 or dev.type != "cuda":
            raise ValueError("ProcessHalo: a rank's shards must all be on "
                             f"one CUDA device, got {sorted(map(str, devices))}")
        if len(mine) > MAX_SHARDS:
            raise ValueError(f"ProcessHalo: {len(mine)} shards a rank, the "
                             f"kernel takes at most {MAX_SHARDS}")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
        self.mesh, self.device, self.shape = mesh, dev, (rows, length)
        self.buf = torch.empty((len(mine), rows, length),
                               dtype=torch.complex64, device=dev)
        handle = ctypes.create_string_buffer(IPC_HANDLE_BYTES)
        offset = ctypes.c_longlong()
        _ipc(_lib().ipc_export(dev.index, self.buf.data_ptr(), handle,
                               ctypes.byref(offset)), "ipc_export")
        every = [None] * dist.get_world_size()
        dist.all_gather_object(every, (handle.raw, offset.value))
        slot = rows * length * self.buf.element_size()
        self.opened = {}  # rank -> its buffer's block, mapped here
        self.src = []     # per local shard: the address it pulls, or None
        for t, s in mine:
            if t == 0:
                self.src.append(None)
            elif mesh.is_local(t - 1, s):
                self.src.append(self.buf[mine.index((t - 1, s))].data_ptr())
            else:
                r = mesh.rank_of(t - 1, s)
                if r not in self.opened:
                    base = ctypes.c_void_p()
                    _ipc(_lib().ipc_open(dev.index, every[r][0],
                                         ctypes.byref(base)), "ipc_open")
                    self.opened[r] = base.value
                self.src.append(self.opened[r] + every[r][1]
                                + mesh.shards_of(r).index((t - 1, s)) * slot)

    def _barrier(self) -> None:
        import torch.distributed as dist

        if dist.get_backend() == "nccl":
            dist.barrier(device_ids=[self.device.index])
        else:
            dist.barrier()

    def __call__(self, parts):
        n_time, n_sc = _grid(parts, self.mesh)
        if self.buf is None:
            raise RuntimeError("ProcessHalo: called after close()")
        mine = self.mesh.local_shards()
        for i, (t, s) in enumerate(mine):
            x = parts[t][s]
            if x.dtype != torch.complex64 or tuple(x.shape) != self.shape:
                raise ValueError(f"ProcessHalo: halos must be complex64 "
                                 f"{list(self.shape)}, got {x.dtype} "
                                 f"{list(x.shape)}")
            self.buf[i].copy_(x)
        stream = torch.cuda.current_stream(self.device)
        stream.synchronize()
        self._barrier()  # every rank's halos are in its buffer
        recv = torch.empty_like(self.buf)
        p = _Params()
        p.src_row_stride, p.rows, p.len = self.shape[1], *self.shape
        p.n_dst = len(mine)
        for k, src in enumerate(self.src):
            p.dst[k] = recv[k].data_ptr()
            p.src[k] = src
        with torch.cuda.device(self.device):
            err = _lib().ring_shift_right(ctypes.byref(p), stream.cuda_stream)
        if err != 0:
            raise RuntimeError(f"ring_shift_right kernel launch failed on "
                               f"{self.device}: CUDA error {err}")
        ring_shift_right.launches += 1
        stream.synchronize()
        self._barrier()  # every pull is done: the buffers may be rewritten
        out = [[None] * n_sc for _ in range(n_time)]
        for k, (t, s) in enumerate(mine):
            out[t][s] = recv[k]
        return out

    def close(self) -> None:
        """Unmap the neighbours' buffers, then meet every rank, so no
        buffer is freed while another rank maps it."""
        if self.buf is None:
            return
        for base in self.opened.values():
            _ipc(_lib().ipc_close(self.device.index, base), "ipc_close")
        self.opened = {}
        self._barrier()
        self.buf = None
