"""Reading the device trace of a traced window.

A ``--trace 1`` run profiles its window with torch.profiler's CUDA
activity alone: the device's kernels, copies and memsets, and the host's
CUDA runtime calls (a launch, a copy, an event's record or wait).
Recording every host operation as well (CPU activity) costs the served
path ~0.5 ms of host time a capture and turns the window host-bound,
so an idle gap on the device is named by the runtime call the host was
in, or "host between CUDA calls" (Python).

Each device operation is given to one layer (``layers/<name>.json``):
to the layer that claims the stage of the timed path it was launched in
(``stages``; the launching runtime call found by the profiler's
correlation id, the stage by the CUDA event records that mark the
stages' bounds: ``cudaEventRecord`` or ``cudaEventRecordWithFlags``), else to the one layer whose kernel-name ``patterns``
match it, else to the layer marked ``fallback``.  A name that two
layers' patterns match, or a stage two layers claim, is refused.
"""

from __future__ import annotations

import bisect
import re
from typing import NamedTuple

IN_PYTHON = "host between CUDA calls"


STAGE_MARK = "cudaEventRecord"


class Op(NamedTuple):
    name: str
    start: float  # µs, the profiler's clock
    end: float
    corr: int = 0  # the profiler's correlation id (0: none)
    stage: str | None = None  # the timed path's stage it was launched in


class TraceError(ValueError):
    """A trace or a layer map that the readers cannot attribute."""


def short_name(name: str) -> str:
    """A kernel's name without namespace, template arguments, parameters
    and return type ("sc_sync_scan", "Memcpy DtoD")."""
    name = name.replace("(anonymous namespace)::", "")
    name = re.sub(r"^void ", "", name).split("(")[0]
    return name.split("<")[0].strip()[:80]


def union_us(ops) -> float:
    busy, end = 0.0, float("-inf")
    for a, b in sorted((o.start, o.end) for o in ops):
        if b > end:
            busy += b - max(a, end)
            end = b
    return busy


def stage_ops(device_ops: list, host_calls: list, captures: int,
              stages) -> list:
    """device_ops with the stage each was launched in.  The host records
    len(stages) + 1 CUDA events a capture (before it, between its
    stages, after it); an operation launched between the k-th and the
    (k+1)-th of a capture's records is of stage k, one launched outside a
    capture's records of none."""
    stages = tuple(stages)
    per = len(stages) + 1
    marks = sorted(h.start for h in host_calls
                   if h.name.startswith(STAGE_MARK))
    if len(marks) != captures * per:
        raise TraceError(f"{len(marks)} {STAGE_MARK} calls in the trace, "
                         f"{captures * per} expected ({captures} captures "
                         f"of {len(stages)} stages)")
    launch = {h.corr: h.start for h in host_calls if h.corr}
    out = []
    for o in device_ops:
        if o.corr not in launch:
            raise TraceError(f"no launching call for {o.name!r} "
                             f"(correlation id {o.corr})")
        k = bisect.bisect_right(marks, launch[o.corr]) - 1
        j = k % per if 0 <= k < len(marks) else per - 1
        out.append(o._replace(stage=stages[j] if j < len(stages) else None))
    return out


class Trace:
    """The device operations and the host's CUDA calls of one traced
    window (``window_s`` long by the host's clock), with the pool index
    of each capture served in it."""

    def __init__(self, device_ops: list, host_calls: list, layers: dict,
                 pool_indices: list, counter_deltas: dict,
                 window_s: float | None = None):
        every = device_ops + host_calls
        self.window = Op("window", min(o.start for o in every),
                         max(o.end for o in every))
        self.ops = device_ops
        self.host = host_calls
        self._window_s = window_s
        self.layers = layers
        self.pool_indices = list(pool_indices)
        self.captures = len(self.pool_indices)
        self.counter_deltas = counter_deltas
        self._layer = {}

    @classmethod
    def from_profiler(cls, prof, layers, pool_indices, counter_deltas,
                      window_s, stages=("decode",)):
        from torch.autograd import DeviceType

        dev, host = [], []
        for e in prof.events():
            op = Op(e.name, e.time_range.start, e.time_range.end,
                    int(e.id or 0))
            (dev if e.device_type == DeviceType.CUDA else host).append(op)
        if len(stages) > 1:
            dev = stage_ops(dev, host, len(pool_indices), stages)
        return cls(dev, host, layers, pool_indices, counter_deltas,
                   window_s)

    @property
    def window_s(self) -> float:
        if self._window_s is not None:
            return self._window_s
        return (self.window.end - self.window.start) * 1e-6

    @property
    def busy_s(self) -> float:
        return union_us(self.ops) * 1e-6

    @property
    def device_span_s(self) -> float:
        """From the first device operation's start to the last's end."""
        if not self.ops:
            return 0.0
        return (max(o.end for o in self.ops)
                - min(o.start for o in self.ops)) * 1e-6

    def layer_of(self, op: Op) -> str:
        key = (op.name, op.stage)
        if key not in self._layer:
            self._layer[key] = self._attribute(*key)
        return self._layer[key]

    def _attribute(self, name: str, stage) -> str:
        claim = [k for k, v in self.layers.items()
                 if stage is not None and stage in v.get("stages", ())]
        if len(claim) > 1:
            raise TraceError(f"stage {stage!r} is claimed by the layers "
                             f"{claim}")
        if claim:
            return claim[0]
        hits = [k for k, v in self.layers.items()
                if any(re.search(p, name) for p in v["patterns"])]
        if len(hits) > 1:
            raise TraceError(f"{name!r} matches the patterns of the layers "
                             f"{hits}")
        if hits:
            return hits[0]
        return next(k for k, v in self.layers.items() if v.get("fallback"))

    def layer_seconds(self, layer: str) -> float:
        return sum(o.end - o.start for o in self.ops
                   if self.layer_of(o) == layer) * 1e-6

    def kernels(self, names=None) -> list:
        """Kernel launches (no copies or memsets), of ``names`` if given
        (each searched for in the kernel's name)."""
        return [o for o in self.ops
                if not re.match(r"Mem(cpy|set)", o.name)
                and (names is None or any(n in o.name for n in names))]

    def kernel_seconds(self, names) -> float:
        return sum(o.end - o.start for o in self.kernels(names)) * 1e-6

    def breakdown(self, top: int = 10) -> dict:
        """The device operations that took most time, by name, and the
        idle time on the device by the CUDA call the host was in."""
        by_op: dict = {}
        for o in self.ops:
            k = short_name(o.name)
            by_op[k] = by_op.get(k, 0.0) + (o.end - o.start) * 1e-6
        gaps: dict = {}
        edge = self.window.start
        merged = []
        for a, b in sorted((o.start, o.end) for o in self.ops):
            if merged and a <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], b)
            else:
                merged.append([a, b])
        host = sorted(self.host, key=lambda r: r.start)
        starts = [r.start for r in host]
        for a, b in merged + [[self.window.end, self.window.end]]:
            if a > edge:
                mid = (edge + a) / 2
                k = bisect.bisect_right(starts, mid) - 1
                name = (host[k].name if k >= 0 and host[k].end >= mid
                        else IN_PYTHON)
                gaps[name] = gaps.get(name, 0.0) + (a - edge) * 1e-6
            edge = max(edge, b)
        order = sorted(by_op.items(), key=lambda kv: -kv[1])[:top]
        return {"device_ops": [[k, v] for k, v in order],
                "idle_gaps": [[k, v] for k, v in sorted(
                    gaps.items(), key=lambda kv: -kv[1])[:top]]}
