"""Collectives over per-shard tensors: what shard_map's lax collectives
gave the JAX package's sharded stages, for one controller that holds
every shard.

A per-shard value is a nested list ``parts[t][s]`` over the mesh (see
parallel.mesh).  Each function returns the same layout, each result
placed on its shard's device (``.to(device)``, free where the shards
share one).  The reductions run in a fixed ascending shard order
(time-major), so a result does not depend on where the shards sit; a
sum with one non-zero contributor per element, as every psum of the
sharded decode is, is exact.
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
    """[[fn(t, s) for s] for t]: a stage body run on every shard."""
    n_time, n_sc = mesh.devices.shape
    return [[fn(t, s) for s in range(n_sc)] for t in range(n_time)]


def _group(mesh: Mesh, t: int, s: int, axes: tuple):
    """The shards that differ from (t, s) only along ``axes``, ascending."""
    n_time, n_sc = mesh.devices.shape
    ts = range(n_time) if "time" in axes else (t,)
    ss = range(n_sc) if "sc" in axes else (s,)
    return [(a, b) for a in ts for b in ss]


def _reduce(parts, mesh: Mesh, axes, op):
    axes = _axes(axes)
    done = {}

    def one(t, s):
        key = tuple(None if ax in axes else i for ax, i in zip(AXES, (t, s)))
        if key not in done:
            members = _group(mesh, t, s, axes)
            acc = parts[members[0][0]][members[0][1]]
            for a, b in members[1:]:
                acc = op(acc, parts[a][b].to(acc.device))
            done[key] = acc
        return done[key].to(mesh.devices[t, s])

    return for_each(mesh, one)


def psum(parts, mesh: Mesh, axes="time"):
    return _reduce(parts, mesh, axes, torch.add)


def pmin(parts, mesh: Mesh, axes="time"):
    return _reduce(parts, mesh, axes, torch.minimum)


def pmax(parts, mesh: Mesh, axes="time"):
    return _reduce(parts, mesh, axes, torch.maximum)


def all_gather(parts, mesh: Mesh, axis: str = "time"):
    """Each shard gets its group's values along ``axis`` stacked on a new
    leading dim, in axis order."""
    axes = _axes(axis)
    if len(axes) != 1:
        raise ValueError("all_gather takes one axis")

    def one(t, s):
        dev = mesh.devices[t, s]
        return torch.stack([parts[a][b].to(dev)
                            for a, b in _group(mesh, t, s, axes)])

    return for_each(mesh, one)


def ppermute_right(parts, mesh: Mesh):
    """Shard (t, s) gets shard (t-1, s)'s value, (0, s) zeros: lax.ppermute
    over "time" with the pairs (j, j+1)."""
    return for_each(mesh, lambda t, s: torch.zeros_like(parts[t][s]) if t == 0
                    else parts[t - 1][s].to(mesh.devices[t, s]))


def ppermute_left(parts, mesh: Mesh):
    """Shard (t, s) gets shard (t+1, s)'s value, the last time shard
    zeros: lax.ppermute over "time" with the pairs (j+1, j)."""
    last = mesh.shape["time"] - 1
    return for_each(mesh, lambda t, s: torch.zeros_like(parts[t][s])
                    if t == last else parts[t + 1][s].to(mesh.devices[t, s]))
