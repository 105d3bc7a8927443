"""Collectives over per-shard tensors: what shard_map's lax collectives
gave the JAX package's sharded stages.

A per-shard value is a nested list ``parts[t][s]`` over the mesh (see
parallel.mesh).  Each function returns the same layout, each result
placed on its shard's device (``.to(device)``, free where the shards
share one).  The reductions fold a group's members in a fixed ascending
shard order (time-major), so a result does not depend on where the
shards sit; a sum with one non-zero contributor per element, as every
psum of the sharded decode is, is exact.

On a mesh over several ranks (``Mesh.spans_processes``) every rank calls
each function with its own shards' values (None elsewhere) and gets its
own shards' results.  A reduction folds the local members in the same
order, then reduces across ranks with ``dist.all_reduce`` (the identity
of the operation where a rank holds no member of a group);
``all_gather`` uses ``dist.all_gather``; the ppermutes exchange with the
neighbour rank by ``dist.batch_isend_irecv``.  These are the library's
collectives, as ``lax.psum`` / ``lax.ppermute`` were the JAX package's.
Gloo has no CUDA form of send / recv or all_gather, so under a gloo group
CUDA tensors are staged through host tensors here (the compute stays on
the card); under NCCL they move from the card.  A mesh whose shards are
all this rank's (a row of the decode's sc stages) never communicates.
"""

from __future__ import annotations

import torch

from rub_mimo_tpu_torch.parallel.mesh import AXES, Mesh


def _axes(axes) -> tuple:
    axes = (axes,) if isinstance(axes, str) else tuple(axes)
    if not axes or any(a not in AXES for a in axes):
        raise ValueError(f"axes must name {AXES}, got {axes}")
    return axes


def for_each(mesh: Mesh, fn):
    """[[fn(t, s) for s] for t]: a stage body run on every shard this
    process holds (None at the others)."""
    n_time, n_sc = mesh.devices.shape
    return [[fn(t, s) if mesh.is_local(t, s) else None for s in range(n_sc)]
            for t in range(n_time)]


def _group(mesh: Mesh, t: int, s: int, axes: tuple):
    """The shards that differ from (t, s) only along ``axes``, ascending."""
    n_time, n_sc = mesh.devices.shape
    ts = range(n_time) if "time" in axes else (t,)
    ss = range(n_sc) if "sc" in axes else (s,)
    return [(a, b) for a in ts for b in ss]


# ------------------------------------------------------------ across ranks
def _dist():
    import torch.distributed as dist

    return dist


def _staged(x: torch.Tensor) -> torch.Tensor:
    """A contiguous copy of x as the group's backend takes it: on the
    host under gloo, else where x is (a reduction works in place on it)."""
    if x.is_cuda and _dist().get_backend() == "gloo":
        return x.detach().to("cpu", copy=True)
    return x.detach().clone(memory_format=torch.contiguous_format)


def _buffer(like: torch.Tensor, shape=None) -> torch.Tensor:
    """An empty receive buffer of like's dtype where _staged puts like."""
    dev = ("cpu" if like.is_cuda and _dist().get_backend() == "gloo"
           else like.device)
    return torch.empty(like.shape if shape is None else shape,
                       dtype=like.dtype, device=dev)


def _check_ranks(mesh: Mesh) -> None:
    every = set(range(_dist().get_world_size()))
    if set(int(r) for r in mesh.ranks.flat) != every:
        raise ValueError("a collective over several ranks needs shards of "
                         "every rank of the group in its mesh")


_IDENTITY = {
    "sum": lambda x: torch.zeros_like(x),
    "min": lambda x: torch.full_like(x, torch.iinfo(x.dtype).max
                                     if not x.is_floating_point()
                                     else float("inf")),
    "max": lambda x: torch.full_like(x, torch.iinfo(x.dtype).min
                                     if not x.is_floating_point()
                                     else float("-inf")),
}
_FOLD = {"sum": torch.add, "min": torch.minimum, "max": torch.maximum}


def _reduce(parts, mesh: Mesh, axes, op: str):
    axes = _axes(axes)
    fold = _FOLD[op]

    def key(t, s):
        return tuple(None if ax in axes else i for ax, i in zip(AXES, (t, s)))

    n_time, n_sc = mesh.devices.shape
    keys = list(dict.fromkeys(key(t, s) for t in range(n_time)
                              for s in range(n_sc)))
    done = {}
    for t, s in mesh.local_shards():
        k = key(t, s)
        if k in done:
            continue
        members = [m for m in _group(mesh, t, s, axes) if mesh.is_local(*m)]
        acc = parts[members[0][0]][members[0][1]]
        for a, b in members[1:]:
            acc = fold(acc, parts[a][b].to(acc.device))
        done[k] = acc
    if mesh.spans_processes:
        dist = _dist()
        _check_ranks(mesh)
        like = next(iter(done.values()))
        if like.is_complex() and op != "sum":
            raise ValueError(f"p{op} of complex values")
        stack = torch.stack([done[k].to(like.device) if k in done
                             else _IDENTITY[op](like) for k in keys])
        buf = _staged(stack)
        dist.all_reduce(buf, op={"sum": dist.ReduceOp.SUM,
                                 "min": dist.ReduceOp.MIN,
                                 "max": dist.ReduceOp.MAX}[op])
        buf = buf.to(like.device)
        done = {k: buf[i] for i, k in enumerate(keys)}
    return for_each(mesh, lambda t, s: done[key(t, s)].to(mesh.devices[t, s]))


def psum(parts, mesh: Mesh, axes="time"):
    return _reduce(parts, mesh, axes, "sum")


def pmin(parts, mesh: Mesh, axes="time"):
    return _reduce(parts, mesh, axes, "min")


def pmax(parts, mesh: Mesh, axes="time"):
    return _reduce(parts, mesh, axes, "max")


def sum_processes(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """x summed over the mesh's ranks (x itself on one process): how the
    sharded decode's stage C assembles the rows each rank owns, every
    element non-zero on one rank at most, so the sum is exact."""
    if not mesh.spans_processes:
        return x
    _check_ranks(mesh)
    buf = _staged(x)
    _dist().all_reduce(buf)
    return buf.to(x.device)


def _gather_grid(parts, mesh: Mesh):
    """Every shard's value on this rank: the local ones as they are, the
    others received (each rank's shards stacked, one all_gather)."""
    dist = _dist()
    _check_ranks(mesh)
    mine = mesh.local_shards()
    like = parts[mine[0][0]][mine[0][1]]
    buf = _staged(torch.stack([parts[t][s].to(like.device) for t, s in mine]))
    world = dist.get_world_size()
    if len({len(mesh.shards_of(r)) for r in range(world)}) != 1:
        raise ValueError("all_gather over ranks that hold unequal shares of "
                         "the mesh")
    got = [torch.empty_like(buf) for _ in range(world)]
    dist.all_gather(got, buf)
    full = [list(row) for row in parts]
    for r in range(world):
        if r == mesh.rank:
            continue
        for i, (t, s) in enumerate(mesh.shards_of(r)):
            full[t][s] = got[r][i]
    return full


def all_gather(parts, mesh: Mesh, axis: str = "time"):
    """Each shard gets its group's values along ``axis`` stacked on a new
    leading dim, in axis order."""
    axes = _axes(axis)
    if len(axes) != 1:
        raise ValueError("all_gather takes one axis")
    if mesh.spans_processes:
        parts = _gather_grid(parts, mesh)

    def one(t, s):
        dev = mesh.devices[t, s]
        return torch.stack([parts[a][b].to(dev)
                            for a, b in _group(mesh, t, s, axes)])

    return for_each(mesh, one)


def _shift(parts, mesh: Mesh, step: int):
    """Shard (t, s) gets shard (t - step, s)'s value, zeros where there is
    none; values held by another rank come by send / receive, the pairs
    of one rank pair in ascending shard order on both sides."""
    n_time = mesh.shape["time"]
    out = for_each(mesh, lambda t, s: None)
    ops, recv = [], []
    dist = _dist() if mesh.spans_processes else None
    for t, s in mesh.local_shards():
        dev, src, dst = mesh.devices[t, s], t - step, t + step
        if not 0 <= src < n_time:
            out[t][s] = torch.zeros_like(parts[t][s])
        elif mesh.is_local(src, s):
            out[t][s] = parts[src][s].to(dev)
        else:
            buf = _buffer(parts[t][s])
            ops.append(dist.P2POp(dist.irecv, buf, mesh.rank_of(src, s)))
            recv.append((t, s, buf))
        if 0 <= dst < n_time and not mesh.is_local(dst, s):
            ops.append(dist.P2POp(dist.isend, _staged(parts[t][s]),
                                  mesh.rank_of(dst, s)))
    if ops:
        for work in dist.batch_isend_irecv(ops):
            work.wait()
    for t, s, buf in recv:
        out[t][s] = buf.to(mesh.devices[t, s])
    return out


def ppermute_right(parts, mesh: Mesh):
    """Shard (t, s) gets shard (t-1, s)'s value, (0, s) zeros: lax.ppermute
    over "time" with the pairs (j, j+1)."""
    return _shift(parts, mesh, 1)


def ppermute_left(parts, mesh: Mesh):
    """Shard (t, s) gets shard (t+1, s)'s value, the last time shard
    zeros: lax.ppermute over "time" with the pairs (j+1, j)."""
    return _shift(parts, mesh, -1)
