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

Across processes (a mesh over several ranks, parallel.mesh) the exchange
is ``ProcessHalo``: one launch a rank a call of csrc/halo_dma.cu's
``halo_exchange_kernel``, which publishes the halos another rank reads,
waits on that rank's flag word and pulls through the IPC-mapped buffer,
all on the device (one rank a card under NCCL, or several ranks on one
card under gloo).  ``exchange_plan``, ``buffer_layout``, ``slot_of`` and
``reuse_epoch`` are the protocol's pure parts, and ``exchange_emulation``
replays it on integer-tagged slots, so the CPU tests hold it without a
card.

Both forms take ``out=``: the destination views the received halos are
written to (stage A's rows in the sharded decode), so a halo is written
once, where it is read.
"""

from __future__ import annotations

import ctypes
import functools
import random
from typing import NamedTuple, Optional

import numpy as np
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
                ("n_dst", ctypes.c_int),
                ("dst_row_stride", ctypes.c_longlong)]


class _ExchangeParams(ctypes.Structure):
    """csrc/halo_dma.cu's ExchangeParams, field for field."""

    _fields_ = [("pub_src", ctypes.c_void_p * MAX_SHARDS),
                ("pull_src", ctypes.c_void_p * MAX_SHARDS),
                ("dst", ctypes.c_void_p * MAX_SHARDS),
                ("arrived", ctypes.c_void_p * MAX_SHARDS),
                ("arrived_dev", ctypes.c_void_p * MAX_SHARDS),
                ("consumed", ctypes.c_void_p * MAX_SHARDS),
                ("consumed_dev", ctypes.c_void_p * MAX_SHARDS),
                ("pub_slot", ctypes.c_void_p),
                ("flags", ctypes.c_void_p),
                ("words", ctypes.c_void_p),
                ("marks", ctypes.c_void_p),
                ("src_row_stride", ctypes.c_longlong),
                ("dst_row_stride", ctypes.c_longlong),
                ("epoch", ctypes.c_ulonglong),
                ("timeout_ns", ctypes.c_ulonglong),
                ("rows", ctypes.c_int),
                ("len", ctypes.c_int),
                ("n_pub", ctypes.c_int),
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
    lib.halo_exchange.argtypes = [ctypes.POINTER(_ExchangeParams),
                                  ctypes.c_void_p]
    lib.halo_exchange.restype = ctypes.c_int
    lib.halo_exchange_load.argtypes = []
    lib.halo_exchange_load.restype = ctypes.c_int
    lib.host_register.argtypes = [ctypes.c_void_p, ctypes.c_longlong,
                                  ctypes.POINTER(ctypes.c_void_p)]
    lib.host_unregister.argtypes = [ctypes.c_void_p]
    lib.host_register.restype = lib.host_unregister.restype = ctypes.c_int
    lib.halo_exchange_blocks.argtypes = [ctypes.c_longlong]
    lib.halo_exchange_blocks.restype = ctypes.c_int
    lib.stream_wait_geq.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                                    ctypes.c_ulonglong]
    lib.stream_wait_geq.restype = ctypes.c_int
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


def _check(flat, who: str = "ring_shift_right", what: str = "halos",
           shape=None) -> None:
    """complex64 [S, H] tensors of one shape (``shape`` where given) with
    contiguous rows and one row stride: what the kernels take."""
    x0 = flat[0]
    want = tuple(x0.shape) if shape is None else tuple(shape)
    for x in flat:
        if x.dtype != torch.complex64:
            raise ValueError(f"{who}: {what} must be complex64, got "
                             f"{x.dtype}")
        if x.dim() != 2 or tuple(x.shape) != want:
            raise ValueError(f"{who}: {what} must be [S, H], all of one "
                             f"shape {list(want)}; got {list(x.shape)}")
        if x.shape[0] > 1 and (x.stride() != x0.stride()
                               or x.stride(0) < x.shape[1]):
            raise ValueError(f"{who}: {what} must share their row stride")
        if x.shape[1] > 1 and x.stride(1) != 1:
            raise ValueError(f"{who}: {what}' rows must be contiguous")
    if min(want) < 1 or x0.numel() >= 1 << 31:
        raise ValueError(f"{who}: halo shape {list(want)} out of range")


def _row_stride(x: torch.Tensor) -> int:
    return max(x.stride(0), x.shape[1])


def _check_out(out, parts, grid, who: str, shape) -> None:
    """``out``, the destinations, laid out as ``parts`` (None where parts
    is None), each on its shard's device, as ``_check`` has it."""
    n_time, n_sc = grid
    if len(out) != n_time or any(len(row) != n_sc for row in out):
        raise ValueError(f"{who}: out must be [{n_time}][{n_sc}] like the "
                         "halos")
    flat = []
    for t in range(n_time):
        for s in range(n_sc):
            x, o = parts[t][s], out[t][s]
            if x is None:
                continue
            if o is None or o.device != x.device:
                raise ValueError(f"{who}: out[{t}][{s}] must be on the "
                                 f"halo's device {x.device}")
            flat.append(o)
    _check(flat, who, "out views", shape)


def _event_on(stream) -> torch.cuda.Event:
    ev = torch.cuda.Event()
    ev.record(stream)
    return ev


def ring_shift_right(parts, mesh, out=None):
    """parts[t][s]: shard (t, s)'s complex64 [S, H] halo (rows may be a
    strided view, e.g. ``local[:, -H:]``), on its shard's device.
    Returns the per-shard [S, H] halos received, each on its shard's
    device: shard (t-1, s)'s for t > 0, zeros for t = 0.  ``out``: where
    they go, [S, H] views laid out as ``parts`` (rows may be strided,
    e.g. stage A's ``rows[i, :, :H]``), returned; fresh tensors without.

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
        ref = ring_shift_right_reference(parts, mesh)
        if out is None:
            return ref
        _check_out(out, parts, (n_time, n_sc), "ring_shift_right",
                   parts[0][0].shape)
        for t in range(n_time):
            for s in range(n_sc):
                out[t][s].copy_(ref[t][s])
        return out
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
    S, H = flat[0].shape
    if out is not None:
        _check_out(out, parts, (n_time, n_sc), "ring_shift_right", (S, H))
    for dst, src in peer_pairs(grid):
        _enable_peer(dst, src)
    stride = _row_stride(flat[0])
    got = [[None] * n_sc for _ in range(n_time)]
    for dev, shards in plan:
        if out is None:
            recv = torch.empty((len(shards), S, H), dtype=torch.complex64,
                               device=dev)
            for k, (t, s) in enumerate(shards):
                got[t][s] = recv[k]
        else:
            for t, s in shards:
                got[t][s] = out[t][s]
        # where trouble is likely (3), launch context: each launch runs
        # under its own card, on that card's current stream, and its
        # parameters hold only that card's destinations and their sources
        p = _Params()
        p.src_row_stride, p.rows, p.len, p.n_dst = stride, S, H, len(shards)
        p.dst_row_stride = _row_stride(got[shards[0][0]][shards[0][1]])
        peers = {}
        for k, (t, s) in enumerate(shards):
            p.dst[k] = got[t][s].data_ptr()
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
    return got


ring_shift_right.launches = 0


# ---------------------------------------------------------------- across
# processes: the protocol's pure parts (csrc/halo_dma.cu's constants)

IPC_HANDLE_BYTES = 64  # cudaIpcMemHandle_t
WORD_BYTES = 8
PUBLISH_COUNT_WORD = 0   # publishing blocks done in the running launch
ARRIVED_WORD = 16        # + k: the last epoch pull k's halo was published
CONSUMED_WORD = 96       # + p: the last epoch published halo p was pulled
PULL_COUNT_WORD = 160    # + k: destination k's blocks done, running launch
FLAG_WORDS = 256         # the slots start this many words in
# what the watchdog writes into a wait word: at or above the kernel's
# kAbort (1 << 62), and with low 32 bits that pass the front end's wait
# as well (its GEQ compares them, cyclically: scripts/
# stream_wait_release.py)
ABORT = (1 << 62) | 0x7FFFFFFF
MARKS = 6                # marks a block: 3 globaltimer (ns), 3 clock64
DEFAULT_TIMEOUT_S = 5.0  # how long a call may wait before it traps


def slot_of(epoch: int) -> int:
    """The slot that call ``epoch`` (1, 2, ...) publishes into and pulls
    from."""
    if epoch < 1:
        raise ValueError(f"epochs start at 1, got {epoch}")
    return epoch % 2


def reuse_epoch(epoch: int) -> int:
    """The epoch whose pull must be done before call ``epoch`` overwrites
    its slot (the slot's previous halo): 0 (nothing to wait for) for the
    first two calls."""
    if epoch < 1:
        raise ValueError(f"epochs start at 1, got {epoch}")
    return max(epoch - 2, 0)


class BufferLayout(NamedTuple):
    """A rank's exported buffer, in bytes: the flag words (its counters
    and its wait words; its host page holds the wait words again at the
    same offsets), then two slots of the halos it publishes, [n_pub,
    rows, length] complex64 each."""

    flag_bytes: int
    halo_bytes: int
    slot_bytes: int
    total_bytes: int

    def word(self, index: int) -> int:
        """Byte offset of flag word ``index``."""
        if not 0 <= index < FLAG_WORDS:
            raise ValueError(f"flag word {index} out of range")
        return index * WORD_BYTES

    def halo(self, epoch: int, p: int) -> int:
        """Byte offset of published halo ``p`` in call ``epoch``'s slot."""
        return (self.flag_bytes + slot_of(epoch) * self.slot_bytes
                + p * self.halo_bytes)


def buffer_layout(n_pub: int, rows: int, length: int) -> BufferLayout:
    if n_pub < 0 or n_pub > MAX_SHARDS or rows < 1 or length < 1:
        raise ValueError(f"buffer_layout: n_pub {n_pub}, halo [{rows}, "
                         f"{length}] out of range")
    halo = rows * length * 8  # complex64
    flag = FLAG_WORDS * WORD_BYTES
    return BufferLayout(flag, halo, n_pub * halo, flag + 2 * n_pub * halo)


class Pull(NamedTuple):
    """How this rank's destination shard (t, s) gets its halo: ``kind``
    "zeros" (t = 0), "local" (shard (t-1, s) is this rank's) or "remote"
    (rank ``source`` publishes it as its halo ``p``)."""

    t: int
    s: int
    kind: str
    source: Optional[int] = None
    p: Optional[int] = None


class Publish(NamedTuple):
    """A halo this rank publishes: shard (t, s)'s, read by rank
    ``reader`` as its destination ``k`` (the flag word it waits on is
    that rank's ARRIVED_WORD + k)."""

    t: int
    s: int
    reader: int
    k: int


class ExchangePlan(NamedTuple):
    """One rank's part of the exchange: ``publish``, this rank's halos
    that another rank reads (published halo p = index), and ``pulls``,
    one a shard of this rank, time-major (destination k = index)."""

    rank: int
    publish: list
    pulls: list

    @property
    def remote(self) -> list:
        """The destinations that pull from another rank."""
        return [k for k, q in enumerate(self.pulls) if q.kind == "remote"]

    @property
    def peers(self) -> list:
        """The ranks whose buffers this rank maps: those it pulls from and
        those it raises an arrived word in, ascending."""
        return sorted({q.source for q in self.pulls if q.kind == "remote"}
                      | {x.reader for x in self.publish})


def exchange_plan(ranks, rank: int) -> ExchangePlan:
    """``ranks[t][s]``: the rank that holds shard (t, s).  Shard (t, s)
    reads shard (t-1, s)'s halo; what crosses ranks is published by the
    holder and pulled by the reader."""
    n_time = len(ranks)

    def mine(r):
        return [(t, s) for t in range(n_time) for s in range(len(ranks[t]))
                if ranks[t][s] == r]

    def publishes(r):
        return [(t, s) for t, s in mine(r)
                if t + 1 < n_time and ranks[t + 1][s] != r]

    pulls = []
    for t, s in mine(rank):
        if t == 0:
            pulls.append(Pull(t, s, "zeros"))
        elif ranks[t - 1][s] == rank:
            pulls.append(Pull(t, s, "local"))
        else:
            src = ranks[t - 1][s]
            pulls.append(Pull(t, s, "remote", src,
                              publishes(src).index((t - 1, s))))
    if len(pulls) > MAX_SHARDS:
        raise ValueError(f"exchange_plan: {len(pulls)} shards a rank, the "
                         f"kernel takes at most {MAX_SHARDS}")
    pub = []
    for t, s in publishes(rank):
        reader = ranks[t + 1][s]
        pub.append(Publish(t, s, reader, mine(reader).index((t + 1, s))))
    return ExchangePlan(rank, pub, pulls)


class Emulation(NamedTuple):
    """What ``exchange_emulation`` saw: ``reads[(rank, epoch, t, s)]``,
    the tags destination (t, s) received in that call, one a block
    (("zeros",) for t = 0, else (epoch, t - 1, s) of the halo read);
    ``overwrites``, each publish that overwrote a slot before its reader
    was done with it (rank, epoch, p); ``steps``, the schedule's length."""

    reads: dict
    overwrites: list
    steps: int


def exchange_emulation(ranks, epochs: int, rng: random.Random,
                       blocks: int = 2, slots: int = 2,
                       reuse_wait: bool = True) -> Emulation:
    """Replay ``epochs`` calls of every rank's exchange (``exchange_plan``
    of ``ranks``) on integer-tagged slots, one step of one block at a
    time, the step picked by ``rng`` among those that can move.  A rank's
    call is its stream: first the front end's waits, each rank's own
    words (consumed >= ``reuse_epoch`` of every halo it publishes, with
    ``reuse_wait``; arrived >= e of every remote pull), then the launch's
    blocks in no order, and call e + 1 once call e's blocks are all done;
    the ranks are free of each other.  A publishing block writes its part
    of slot e % ``slots`` and counts itself; the last raises arrived = e
    in each reader's flags.  A remote pull's block reads its part and
    counts itself; the last raises consumed = e in the source's flags.
    Raises RuntimeError where nothing can move before every call is done
    (a schedule that does not terminate).  ``slots`` and ``reuse_wait``
    exist to show what the checks catch without them."""
    n_ranks = 1 + max(r for row in ranks for r in row)
    plans = [exchange_plan(ranks, r) for r in range(n_ranks)]
    arrived = [[0] * len(pl.pulls) for pl in plans]
    consumed = [[0] * len(pl.publish) for pl in plans]
    # slot[rank][k][p][b]: block b's part of published halo p in slot k
    slot = [[[[None] * blocks for _ in pl.publish] for _ in range(slots)]
            for pl in plans]
    parts_read = {}  # (source rank, p, epoch) -> parts read of it
    reads, overwrites = {}, []

    def front_end(r, e):
        pl = plans[r]
        while not ((not reuse_wait or all(
                c >= reuse_epoch(e) for c in consumed[r]))
                and all(arrived[r][k] >= e for k in pl.remote)):
            yield False
        yield True

    def publisher(r, e, p, b, count):
        pub = plans[r].publish[p]
        yield True
        if e > slots and b not in parts_read.get((r, p, e - slots), ()):
            overwrites.append((r, e, p))
        slot[r][e % slots][p][b] = (e, pub.t, pub.s)
        count[0] += 1
        if count[0] == len(plans[r].publish) * blocks:
            yield True
            for x in plans[r].publish:
                arrived[x.reader][x.k] = e

    def puller(r, e, q, b, count):
        yield True
        if q.kind == "zeros":
            reads[r, e, q.t, q.s][b] = ("zeros",)
            return
        if q.kind == "local":  # the source view of this call
            reads[r, e, q.t, q.s][b] = (e, q.t - 1, q.s)
            return
        reads[r, e, q.t, q.s][b] = slot[q.source][e % slots][q.p][b]
        parts_read.setdefault((q.source, q.p, e), set()).add(b)
        count[0] += 1
        if count[0] == blocks:
            yield True
            consumed[q.source][q.p] = e

    def launch(r, e):
        pub_count = [0]
        gens = [publisher(r, e, p, b, pub_count)
                for p in range(len(plans[r].publish)) for b in range(blocks)]
        for q in plans[r].pulls:
            reads[r, e, q.t, q.s] = [None] * blocks
            count = [0]
            gens += [puller(r, e, q, b, count) for b in range(blocks)]
        return gens

    epoch = [1] * n_ranks
    gate = [front_end(r, 1) for r in range(n_ranks)]  # None: launched
    running = [[] for _ in range(n_ranks)]
    steps = 0
    while True:
        movable = []
        for r in range(n_ranks):
            if gate[r] is None and not running[r] and epoch[r] <= epochs:
                epoch[r] += 1  # every block of the call is done
                if epoch[r] <= epochs:
                    gate[r] = front_end(r, epoch[r])
            if epoch[r] > epochs:
                continue
            movable += [(r, gate[r])] if gate[r] is not None else \
                [(r, g) for g in running[r]]
        if not movable:
            break
        rng.shuffle(movable)
        for r, g in movable:
            try:
                moved = next(g)
            except StopIteration:
                running[r].remove(g)
                moved = True
            if moved:
                if g is gate[r]:
                    gate[r] = None
                    running[r] = launch(r, epoch[r])
                steps += 1
                break
        else:
            raise RuntimeError(f"exchange_emulation: nothing can move at "
                               f"epochs {epoch} (arrived {arrived}, "
                               f"consumed {consumed})")
    return Emulation(reads, overwrites, steps)


def split_us(marks, n_pub: int, remote: list) -> dict:
    """The time split of one exchange launch from its marks ([jobs,
    blocks, MARKS] int64: globaltimer ns at a block's start, after its
    acquire, after its copy, then clock64 at the same points; jobs are
    the published halos, then the destinations): ``publish_us`` from the
    first publishing block past its acquire to the last one done,
    ``publish_wait_us`` the longest slot-reuse acquire; for the remote
    pulls (destination indices ``remote``) ``wait_us`` the longest acquire
    of a block and ``pull_us`` from the first block past it to the last
    one done, ``pull_block_cycles`` the longest copy of a block in SM
    cycles; ``span_us`` from the first block's start to the last one done.
    None where the launch has no such job.  The stream's own waits come
    before the launch: they are not in the marks."""
    m = np.asarray(marks, dtype=np.int64)

    def us(x):
        return float(x) / 1e3

    out = {"span_us": us(m[..., 2].max() - m[..., 0].min())}
    pub = m[:n_pub]
    out["publish_us"] = us(pub[..., 2].max() - pub[..., 1].min()) \
        if n_pub else None
    out["publish_wait_us"] = us((pub[..., 1] - pub[..., 0]).max()) \
        if n_pub else None
    rem = m[[n_pub + k for k in remote]]
    if len(remote):
        out.update(wait_us=us((rem[..., 1] - rem[..., 0]).max()),
                   pull_us=us(rem[..., 2].max() - rem[..., 1].min()),
                   pull_block_cycles=int((rem[..., 5] - rem[..., 4]).max()))
    else:
        out.update(wait_us=None, pull_us=None, pull_block_cycles=None)
    return out


def _ipc(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"ProcessHalo: {what} failed: CUDA error {err}")


class _Watchdog:
    """Releases a call's stream waits that outlive the limit: each call
    registers, before its waits, an event recorded ahead of them, and
    after its launch one recorded behind it; a thread polls the oldest
    unfinished call, and once the stream has reached its waits and
    ``timeout_s`` passed without the launch done, marks the exchange
    failed (``halo.fail``) and has it raise every wait word of the rank
    to ABORT (``halo.release_waits``: a store from the host), so the
    waits end and the kernel traps on the word.  A launch may itself
    block the host while the stream is held, as a full launch queue
    does: the call is registered before it."""

    def __init__(self, halo, timeout_s: float):
        import collections
        import threading

        self.halo, self.timeout_s = halo, timeout_s
        self.period = min(timeout_s / 8, 0.1)
        self.calls = collections.deque()  # [reached, done, first seen]
        self.lock = threading.Lock()
        self.stop = threading.Event()
        self.thread = None

    def add(self, reached) -> list:
        """Register a call whose waits follow ``reached``; set the entry's
        [1] to the event behind its launch once queued."""
        entry = [reached, None, None]
        with self.lock:
            self.calls.append(entry)
        if self.thread is None:
            import threading

            self.thread = threading.Thread(target=self._run, daemon=True,
                                           name="ProcessHalo watchdog")
            self.thread.start()
        return entry

    def _run(self) -> None:
        import time

        try:
            while not self.stop.wait(self.period):
                with self.lock:
                    while self.calls and self.calls[0][1] is not None \
                            and self.calls[0][1].query():
                        self.calls.popleft()
                    oldest = self.calls[0] if self.calls else None
                if oldest is None or not oldest[0].query():
                    continue
                now = time.monotonic()
                if oldest[2] is None:
                    oldest[2] = now
                elif now - oldest[2] > self.timeout_s:
                    self.halo.fail(f"a wait passed {self.timeout_s} s")
                    self.halo.release_waits()
                    return
        except RuntimeError:  # the context failed: nothing left to watch
            return

    def close(self) -> None:
        self.stop.set()
        if self.thread is not None:
            self.thread.join()


class _HostPage:
    """A rank's wait words: a page of POSIX shared memory, created
    (zeroed) by its rank, attached by name by the ranks that raise its
    words, and registered with CUDA in each process (``dev``: where this
    process's kernels and stream waits reach it; ``words``: the host's
    view)."""

    BYTES = 4096

    def __init__(self, name: Optional[str] = None):
        from multiprocessing import resource_tracker, shared_memory

        self.owner = name is None
        self.shm = shared_memory.SharedMemory(name=name, create=self.owner,
                                              size=self.BYTES)
        if not self.owner:  # its creator unlinks it, not this process
            resource_tracker.unregister(self.shm._name, "shared_memory")
        self.words = np.ndarray((FLAG_WORDS,), dtype=np.uint64,
                                buffer=self.shm.buf)
        if self.owner:
            self.words[:] = 0
        self.host = self.words.ctypes.data
        dev = ctypes.c_void_p()
        _ipc(_lib().host_register(self.host, self.BYTES, ctypes.byref(dev)),
             "host_register")
        self.dev = dev.value

    @property
    def name(self) -> str:
        return self.shm.name

    def close(self) -> None:
        _ipc(_lib().host_unregister(self.host), "host_unregister")
        del self.words
        self.shm.close()
        if self.owner:
            self.shm.unlink()


class ProcessHalo:
    """K8 across processes, on a mesh over several ranks whose shards each
    rank holds on one CUDA device: ``halo(parts, out=None)`` is
    ring_shift_right of the ranks' [rows, length] complex64 halos, each
    rank passing and getting its own shards' (None elsewhere), with one
    launch of csrc/halo_dma.cu's exchange kernel a rank a call and no
    host synchronization: no barrier, no stream or device synchronize, no
    copy.  ``out``: where this rank's received halos go ([rows, length]
    views laid out as ``parts``, rows may be strided), returned; fresh
    tensors without.

    At construction (every rank at once) each rank allocates and zeroes
    one device buffer (``buffer_layout``: its counters, then two slots of
    the halos it publishes, ``exchange_plan``) and one host page of wait
    words (``_HostPage``), exports the buffer (``ipc_export``: the handle
    covers the caching allocator's whole block, so the byte offset goes
    with it), and the handles and page names go across once through the
    group; each rank maps the buffers and pages of the ranks it pulls
    from and raises words in (``ipc_open``).  Call ``epoch`` (1, 2, ...) queues on
    the current stream one wait a flag word of this rank (the card's
    front end holds them; the halos it publishes pulled at
    ``reuse_epoch(epoch)``, the halos it pulls published at ``epoch``),
    then the launch: it publishes into slot ``slot_of(epoch)`` and raises
    each reader's arrived word, pulls, and raises each source's consumed
    word: the TPU kernel's send and receive semaphores, as flag words on
    the device.  Every rank must make the same calls in the same order.

    ``timeout_s``: a call whose waits outlast it once the stream has
    reached them is released by a watchdog thread, and its kernel traps:
    the caller's next synchronization raises, and nothing returns stale
    halos, zeros or the plain version.  A failed call (or a decode that
    raised around one, which marks it with ``fail``) leaves the ranks'
    epochs apart: every later call raises, and the decoder must be
    closed and rebuilt on every rank.  ``close`` (every rank at once)
    waits for this rank's stream, unmaps the neighbours' buffers and
    meets the others at a barrier before the buffers may be freed."""

    def __init__(self, mesh, rows: int, length: int,
                 timeout_s: float = DEFAULT_TIMEOUT_S):
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
        if not timeout_s > 0:
            raise ValueError(f"ProcessHalo: timeout_s must be > 0, got "
                             f"{timeout_s}")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
        n_time, n_sc = mesh.shape["time"], mesh.shape["sc"]
        grid = [[mesh.rank_of(t, s) for s in range(n_sc)]
                for t in range(n_time)]
        self.mesh, self.device, self.shape = mesh, dev, (rows, length)
        self.plan = exchange_plan(grid, mesh.rank)
        self.layout = buffer_layout(len(self.plan.publish), rows, length)
        self.epoch, self.failed = 0, None
        self.buf = torch.zeros(self.layout.total_bytes, dtype=torch.uint8,
                               device=dev)
        self.page = _HostPage()
        # the counters are zero before any other rank can map them
        torch.cuda.synchronize(dev)
        handle = ctypes.create_string_buffer(IPC_HANDLE_BYTES)
        offset = ctypes.c_longlong()
        _ipc(_lib().ipc_export(dev.index, self.buf.data_ptr(), handle,
                               ctypes.byref(offset)), "ipc_export")
        every = [None] * dist.get_world_size()
        dist.all_gather_object(every, (handle.raw, offset.value,
                                       self.page.name))
        self.opened, self.pages = {}, {}  # rank -> its block, its page
        theirs = {}       # rank -> (its buffer here, its layout)
        for r in self.plan.peers:
            base = ctypes.c_void_p()
            _ipc(_lib().ipc_open(dev.index, every[r][0], ctypes.byref(base)),
                 "ipc_open")
            self.opened[r] = base.value
            self.pages[r] = _HostPage(every[r][2])
            theirs[r] = (base.value + every[r][1], buffer_layout(
                len(exchange_plan(grid, r).publish), rows, length))
        own = self.buf.data_ptr()
        # what does not change from call to call
        p = _ExchangeParams()
        p.flags, p.words = self.page.dev, own
        p.rows, p.len = rows, length
        p.n_pub, p.n_dst = len(self.plan.publish), len(self.plan.pulls)
        p.timeout_ns = int(timeout_s * 1e9)
        for i, x in enumerate(self.plan.publish):
            word = self.layout.word(ARRIVED_WORD + x.k)
            p.arrived[i] = self.pages[x.reader].dev + word
            p.arrived_dev[i] = theirs[x.reader][0] + word
        # per remote pull: (k, the halo's address in its source's slots
        # 0 and 1); slot_of(2) = 0, slot_of(1) = 1
        self._slots = []
        for k in self.plan.remote:
            q = self.plan.pulls[k]
            at, lay = theirs[q.source]
            word = lay.word(CONSUMED_WORD + q.p)
            p.consumed[k] = self.pages[q.source].dev + word
            p.consumed_dev[k] = at + word
            self._slots.append((k, [at + lay.halo(e, q.p) for e in (2, 1)]))
        self._own_slots = [own + self.layout.halo(e, 0) for e in (2, 1)]
        self._static = p
        # this rank's wait words: (word index, kind) with kind "consumed"
        # (reuse_epoch) or "arrived" (the epoch)
        self._wait_words = (
            [(CONSUMED_WORD + i, "consumed")
             for i in range(len(self.plan.publish))]
            + [(ARRIVED_WORD + k, "arrived") for k in self.plan.remote])
        self.timeout_s = float(timeout_s)
        self._watchdog = _Watchdog(self, self.timeout_s)
        with torch.cuda.device(dev):
            _ipc(_lib().halo_exchange_load(), "loading the kernel")

    @property
    def remote(self) -> list:
        """The destination indices (jobs after the published halos) that
        pull from another rank."""
        return self.plan.remote

    def marks_buffer(self) -> torch.Tensor:
        """A zeroed int64 [jobs, blocks, MARKS] tensor for ``marks=``: one
        call's time split, read with ``split_us``."""
        blocks = _lib().halo_exchange_blocks(self.shape[0] * self.shape[1])
        return torch.zeros((len(self.plan.publish) + len(self.plan.pulls),
                            blocks, MARKS), dtype=torch.int64,
                           device=self.device)

    def fail(self, why: str) -> None:
        """Mark the exchange failed: every later call raises."""
        if self.failed is None:
            self.failed = why

    def release_waits(self) -> None:
        """Raise every wait word of this rank to ABORT, a store from the
        host into its page: the stream's waits end (the card's front end
        reads the page) and the exchange kernel traps."""
        for index, _ in self._wait_words:
            self.page.words[index] = ABORT

    def __call__(self, parts, out=None, marks=None):
        p, out = self.params(parts, out, marks)
        stream = torch.cuda.current_stream(self.device)
        h = stream.cuda_stream
        reached = torch.cuda.Event()
        try:
            with torch.cuda.device(self.device):
                reached.record(stream)
                entry = self._watchdog.add(reached)
                for index, kind in self._wait_words:
                    want = p.epoch if kind == "arrived" else \
                        reuse_epoch(p.epoch)
                    if want:
                        err = _lib().stream_wait_geq(
                            h, self.page.dev + index * WORD_BYTES, want)
                        if err != 0:
                            raise RuntimeError(f"ProcessHalo: the stream's "
                                               f"wait failed: CUDA error "
                                               f"{err}")
                err = _lib().halo_exchange(ctypes.byref(p), h)
                if err != 0:
                    raise RuntimeError(f"halo_exchange kernel launch failed "
                                       f"on {self.device}: CUDA error {err}")
                done = torch.cuda.Event()
                done.record(stream)
                entry[1] = done
        except BaseException as exc:
            self.fail(repr(exc))
            raise
        self.epoch = p.epoch
        ring_shift_right.launches += 1
        return out

    def params(self, parts, out=None, marks=None):
        """The next call's kernel parameters (its epoch is one past
        ``epoch``) and its destinations, after every check a call makes;
        the call itself queues the waits and the launch."""
        n_time, n_sc = _grid(parts, self.mesh)
        if self.buf is None:
            raise RuntimeError("ProcessHalo: called after close()")
        if self.failed is not None:
            raise RuntimeError(f"ProcessHalo: an earlier call failed "
                               f"({self.failed}); the ranks' epochs are "
                               "apart: close the decoder and build it "
                               "again on every rank")
        local = [parts[q.t][q.s] for q in self.plan.pulls]
        if any(x is None or x.device != self.device for x in local):
            raise ValueError(f"ProcessHalo: this rank's halos must be on "
                             f"{self.device}")
        _check(local, "ProcessHalo", "halos", self.shape)
        if out is None:
            recv = torch.empty((len(local), *self.shape),
                               dtype=torch.complex64, device=self.device)
            out = [[None] * n_sc for _ in range(n_time)]
            for k, q in enumerate(self.plan.pulls):
                out[q.t][q.s] = recv[k]
        else:
            _check_out(out, parts, (n_time, n_sc), "ProcessHalo",
                       self.shape)
        if marks is not None and (marks.dtype != torch.int64
                                  or marks.device != self.device
                                  or not marks.is_contiguous()):
            raise ValueError("ProcessHalo: marks must be marks_buffer()'s")
        e = self.epoch + 1
        p = _ExchangeParams.from_buffer_copy(self._static)
        p.epoch = e
        p.src_row_stride = _row_stride(local[0])
        for i, x in enumerate(self.plan.publish):
            p.pub_src[i] = parts[x.t][x.s].data_ptr()
        p.pub_slot = self._own_slots[e % 2]
        for k, q in enumerate(self.plan.pulls):
            p.dst[k] = out[q.t][q.s].data_ptr()
            if q.kind == "local":
                p.pull_src[k] = parts[q.t - 1][q.s].data_ptr()
        for k, addrs in self._slots:
            p.pull_src[k] = addrs[e % 2]
        first = self.plan.pulls[0]
        p.dst_row_stride = _row_stride(out[first.t][first.s])
        p.marks = 0 if marks is None else marks.data_ptr()
        return p, out

    def close(self) -> None:
        """Wait for this rank's stream (its last pulls and releases), unmap
        the neighbours' buffers, then meet every rank, so no buffer is
        freed while another rank maps or reads it."""
        import torch.distributed as dist

        if self.buf is None:
            return
        self._watchdog.close()
        torch.cuda.current_stream(self.device).synchronize()
        for base in self.opened.values():
            _ipc(_lib().ipc_close(self.device.index, base), "ipc_close")
        for page in self.pages.values():
            page.close()
        self.opened, self.pages = {}, {}
        if dist.get_backend() == "nccl":
            dist.barrier(device_ids=[self.device.index])
        else:
            dist.barrier()
        self.page.close()
        self.buf = None
