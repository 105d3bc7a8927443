"""The ("time", "sc") device mesh of the sharded decode (port of
rub_mimo_tpu/parallel/mesh.py).

  "time" — time blocks of the capture: the S&C sync and the payload
           symbols are data-parallel in time, with overlap-save halos at
           the shard boundaries.
  "sc"   — the second axis: the matched filter's templates, the LS code
           FFTs and the payload symbols are striped over it.

One controller process drives every shard (the JAX package's design
under shard_map).  A mesh is a grid of torch devices, and a device may
repeat: ``make_mesh(4, 1, devices=["cuda:0"] * 4)`` gives four logical
shards of one card, as the JAX package's tests put eight on one CPU.  A
sharded capture is a nested list ``blocks[t][s]`` of [S, Tloc] tensors,
each on its shard's device (the blocks of one time row are the same
tensor where their devices agree).

Several processes (the JAX package's multi-host runtime): after
``init_distributed`` each process ("rank") calls ``make_mesh`` with its
own devices, and the mesh lays every rank's devices out rank-major,
time-major, as ``jax.make_mesh`` lays out processes: the "time" axis
spans the ranks and each rank holds whole time rows.  ``Mesh.ranks``
records the rank that holds each shard; a rank runs the stage bodies of
its own shards only, and ``shard_capture`` gives it only its own blocks
(``None`` elsewhere).  parallel.collectives then moves values between
ranks through torch.distributed.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Optional, Sequence

import numpy as np
import torch

AXES = ("time", "sc")


BACKENDS = ("nccl", "gloo")


def init_distributed(coordinator_address: Optional[str] = None,
                     num_processes: Optional[int] = None,
                     process_id: Optional[int] = None, *, backend: str,
                     init_method: Optional[str] = None) -> None:
    """Join this process to a group of ``num_processes`` ranks as rank
    ``process_id``: torch.distributed.init_process_group, the counterpart
    of the JAX package's jax.distributed.initialize.  Call once per
    process before make_mesh.

    coordinator_address "host:port" rendezvous at tcp://host:port;
    init_method (e.g. "file:///path/store") is passed as it is; with
    neither, the environment's MASTER_ADDR / MASTER_PORT / RANK /
    WORLD_SIZE (as torchrun sets them).  backend is the caller's, never
    switched: "nccl" (one rank a card; this process's card is
    LOCAL_RANK's, else process_id modulo the cards) or "gloo" (CPU ranks,
    or several ranks sharing one card)."""
    import torch.distributed as dist

    if backend not in BACKENDS:
        raise ValueError(f"backend must be one of {BACKENDS}, got "
                         f"{backend!r}")
    if backend == "nccl" and not torch.cuda.is_available():
        raise RuntimeError("init_distributed: backend='nccl' needs CUDA; "
                           "use backend='gloo' for CPU ranks")
    if coordinator_address is not None and init_method is not None:
        raise ValueError("pass coordinator_address or init_method, not both")
    if coordinator_address is not None:
        init_method = f"tcp://{coordinator_address}"
    env = init_method is None or init_method.startswith("env://")
    if num_processes is None:
        num_processes = int(os.environ["WORLD_SIZE"]) if env else None
    if process_id is None:
        process_id = int(os.environ["RANK"]) if env else None
    if num_processes is None or process_id is None:
        raise ValueError("num_processes and process_id are needed with "
                         f"init_method {init_method!r}")
    if backend == "nccl":
        local = os.environ.get("LOCAL_RANK")
        torch.cuda.set_device(int(local) if local is not None
                              else process_id % torch.cuda.device_count())
    dist.init_process_group(backend, init_method=init_method or "env://",
                            world_size=num_processes, rank=process_id)


def _group() -> Optional[tuple]:
    """(rank, world size) of this process's group, or None without one."""
    import torch.distributed as dist

    if not (dist.is_available() and dist.is_initialized()):
        return None
    return dist.get_rank(), dist.get_world_size()


@dataclasses.dataclass(frozen=True, eq=False)
class Mesh:
    """devices: numpy object array [n_time, n_sc] of torch.device.
    ranks: int array of the same shape, the rank that holds each shard,
    or None where this process holds them all; rank: this process's."""

    devices: np.ndarray
    axis_names: tuple = AXES
    ranks: Optional[np.ndarray] = None
    rank: int = 0

    @property
    def shape(self) -> dict:
        n_time, n_sc = self.devices.shape
        return {"time": n_time, "sc": n_sc}

    @property
    def spans_processes(self) -> bool:
        """Whether the shards belong to more than one rank."""
        return self.ranks is not None and len(set(self.ranks.flat)) > 1

    def rank_of(self, t: int, s: int) -> int:
        return self.rank if self.ranks is None else int(self.ranks[t, s])

    def is_local(self, t: int, s: int) -> bool:
        return self.rank_of(t, s) == self.rank

    def shards_of(self, rank: int) -> list:
        """The shards ``rank`` holds, (t, s) time-major."""
        n_time, n_sc = self.devices.shape
        return [(t, s) for t in range(n_time) for s in range(n_sc)
                if self.rank_of(t, s) == rank]

    def local_shards(self) -> list:
        return self.shards_of(self.rank)

    def sub(self, rows: slice = slice(None), cols: slice = slice(None)):
        """The mesh of the shards [rows, cols] (a column or a row)."""
        return Mesh(self.devices[rows, cols], self.axis_names,
                    None if self.ranks is None else self.ranks[rows, cols],
                    self.rank)

    @property
    def home(self) -> torch.device:
        """Where the decode's replicated results are returned: the device
        of this rank's first shard (shard (0, 0)'s on one process)."""
        t, s = self.local_shards()[0]
        return self.devices[t, s]


def make_mesh(num_time: Optional[int] = None, num_sc: int = 1,
              devices: Optional[Sequence] = None) -> Mesh:
    """A ("time", "sc") mesh over ``devices`` (default: every CUDA
    device, raising where there is none), laid out time-major; the first
    num_time * num_sc devices are used.

    Under init_distributed, ``devices`` are this rank's own (default: its
    current CUDA device); every rank passes as many, and the mesh takes
    every rank's, rank-major.  Each rank must hold whole time rows (its
    device count a multiple of num_sc)."""
    grp = _group()
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError("make_mesh: no CUDA device; pass devices "
                               "(e.g. ['cpu'] * n) for a CPU mesh")
        devices = ([torch.device("cuda", torch.cuda.current_device())]
                   if grp is not None else
                   [torch.device("cuda", i)
                    for i in range(torch.cuda.device_count())])
    devices = [torch.device(d) for d in devices]
    for d in devices:
        if d.type == "cuda" and (not torch.cuda.is_available() or (
                d.index or 0) >= torch.cuda.device_count()):
            raise RuntimeError(f"make_mesh: device {d} is not available")
    owners = None
    if grp is not None and grp[1] > 1:
        import torch.distributed as dist

        every = [None] * grp[1]
        dist.all_gather_object(every, [str(d) for d in devices])
        if len({len(e) for e in every}) != 1:
            raise ValueError("make_mesh: every rank must pass as many "
                             f"devices; got {[len(e) for e in every]}")
        n_local = len(devices)
        if n_local % num_sc:
            raise ValueError(f"make_mesh: a rank's {n_local} devices must "
                             f"hold whole time rows of {num_sc} shards")
        devices = [torch.device(d) for e in every for d in e]
        owners = [r for r in range(grp[1]) for _ in range(n_local)]
    if num_time is None:
        num_time = len(devices) // num_sc
    need = num_time * num_sc
    if num_time < 1 or num_sc < 1 or need > len(devices):
        raise ValueError(f"mesh {num_time}x{num_sc} needs {need} devices, "
                         f"have {len(devices)}")
    if owners is not None and need != len(devices):
        raise ValueError(f"mesh {num_time}x{num_sc} must use every rank's "
                         f"devices ({len(devices)})")
    grid = np.empty((num_time, num_sc), dtype=object)
    for i, d in enumerate(devices[:need]):
        grid[i // num_sc, i % num_sc] = d
    if owners is None:
        return Mesh(grid)
    return Mesh(grid, ranks=np.asarray(owners).reshape(num_time, num_sc),
                rank=grp[0])


def _blocks(x: torch.Tensor, mesh: Mesh):
    """x [S, T] (T a multiple of n_time) -> blocks[t][s] on each shard's
    device, contiguous; None where another rank holds the shard."""
    n_time, n_sc = mesh.devices.shape
    Tloc = x.shape[-1] // n_time
    out = []
    for t in range(n_time):
        blk = x[:, t * Tloc:(t + 1) * Tloc]
        on = {}  # one copy per device: a row's shards share it
        row = []
        for s in range(n_sc):
            d = mesh.devices[t, s]
            if not mesh.is_local(t, s):
                row.append(None)
                continue
            if d not in on:
                on[d] = blk.to(d).contiguous()
            row.append(on[d])
        out.append(row)
    return out


def _padded_len(T: int, mesh: Mesh) -> int:
    """T padded up to a multiple of n_time * 128 (zeros: trailing silence
    is harmless to the decode), so every shard is equal-sized and a
    multiple of every coarse-sync stride."""
    q = mesh.shape["time"] * 128
    return -(-T // q) * q


def shard_capture(iq, mesh: Mesh):
    """A [S, T] complex64 capture (tensor or numpy) -> blocks[t][s]
    complex64 [S, Tloc], T zero-padded to a multiple of n_time * 128;
    on a mesh over several ranks, this rank's blocks (None elsewhere)."""
    x = torch.as_tensor(iq).to(torch.complex64)
    T = x.shape[-1]
    x = torch.nn.functional.pad(x, (0, _padded_len(T, mesh) - T))
    return _blocks(x, mesh)


def shard_capture_planes(iq, mesh: Mesh):
    """``shard_capture`` as (re, im) float32 planes: (re_blocks,
    im_blocks), for build_sharded_decoder(input_format="planes")."""
    x = torch.as_tensor(iq).to(torch.complex64)
    T = x.shape[-1]
    x = torch.nn.functional.pad(x, (0, _padded_len(T, mesh) - T))
    return (_blocks(x.real.contiguous(), mesh),
            _blocks(x.imag.contiguous(), mesh))
