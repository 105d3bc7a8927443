"""The program's spans, counters and device marks, read beside the device
trace of a traced window.

The program (``rub_mimo_tpu_torch.utils.profiling``) records host spans
while a torch.profiler records, so a traced window's captures have
theirs: ``serve`` (children ``serve.prepare``, ``serve.copy_in``,
``serve.replay``, ``serve.copy_out``); its set-up spans
(``setup.graph``, ``setup.warm_decode``, ``setup.kernel_load``) are kept
always; its counters count the served captures and their eager copies.
``spans_snapshot()`` hands them over after the window.  Where the
program has no recorder (a commit before it), every reader here finds
nothing and returns None.

The spans are stamped with the host's ``time.perf_counter_ns``; the
trace keeps its own clock.  ``clock`` maps the one onto the other by a
line fitted on anchors: each ``serve.replay`` span holds exactly one
``cudaGraphLaunch`` runtime call.  ``copy_check_us`` tests the mapping on
another kind of call, the ``cudaMemcpyAsync`` of each eager copy, which
must fall inside its ``serve.copy_in`` or ``serve.copy_out`` span.  The
mapping joins spans to the trace's host calls only: the trace's device
times drift against its host times within a window on the H100 machines
(a device operation read up to 5.6 ms before the call that launched it),
so nothing here subtracts a host time from a device time.  What it is
for: the host time of a ``serve`` span outside the trace's host calls
(``serve_host``), which the profiler's cost on each CUDA call does not
lengthen, and the device operations ``serve()`` launches
(``launched_in``).
"""

from __future__ import annotations

import bisect
import statistics
import sys
from typing import NamedTuple

import numpy as np

TOL_US = 5.0  # a call may lie this far outside its span on the mapped clock


def say(msg: str) -> None:
    print(f"portbench.spans: {msg}", file=sys.stderr)


def snapshot(ctx):
    """The program's snapshot (kept on ``ctx``), or None where the program
    has no recorder."""
    if not hasattr(ctx, "spans"):
        snap = None
        try:
            from rub_mimo_tpu_torch.utils import profiling
        except ImportError:
            profiling = None
        get = getattr(profiling, "spans_snapshot", None)
        if get is not None:
            snap = get()
        ctx.spans = snap
    return ctx.spans


def _memo(fn):
    """fn(ctx), computed once a run (kept on ``ctx``)."""
    def once(ctx):
        memo = ctx.__dict__.setdefault("_spans_memo", {})
        if fn.__name__ not in memo:
            memo[fn.__name__] = fn(ctx)
        return memo[fn.__name__]
    once.__doc__ = fn.__doc__
    return once


@_memo
def window(ctx):
    """The spans of the traced window's captures (the last
    ``trace.captures`` served), oldest first, or None: no spans, or the
    ring overwrote some of the window's (said on standard error)."""
    snap = snapshot(ctx)
    n = ctx.trace.captures if ctx.trace is not None else 0
    if not snap or not n:
        return None
    spans = snap["spans"]
    serves = [s for s in spans if s["name"] == "serve"]
    if len(serves) < n:
        if snap["counters"].get("spans.dropped"):
            say(f"spans.dropped {snap['counters']['spans.dropped']}: "
                f"{len(serves)} serve spans kept for {n} captures")
        return None
    first = serves[-n]["seq"]
    if snap["counters"].get("spans.dropped") and spans[0]["seq"] >= first:
        say(f"spans.dropped {snap['counters']['spans.dropped']}: the ring "
            "overwrote spans of the window's first capture")
        return None
    return [s for s in spans if s["seq"] >= first and s["end_ns"]]


class Clock(NamedTuple):
    """trace µs = a + b (ns - x0); ``worst_us``: the farthest any anchor's
    launch lies outside its span on the mapped clock."""
    a: float
    b: float
    x0: int
    worst_us: float

    def us(self, ns) -> float:
        return self.a + self.b * (ns - self.x0)


def _named(spans, name):
    return sorted((s for s in spans if s["name"] == name),
                  key=lambda s: s["start_ns"])


def _calls(trace, name):
    return sorted((h for h in trace.host if h.name == name),
                  key=lambda h: h.start)


@_memo
def clock(ctx):
    """The mapping of the window's span times onto the trace's, fitted
    on the serve.replay spans and the cudaGraphLaunch calls (paired in
    order), or None."""
    spans = window(ctx)
    if spans is None:
        return None
    reps = _named(spans, "serve.replay")
    launches = _calls(ctx.trace, "cudaGraphLaunch")
    if not reps or len(reps) != len(launches):
        say(f"{len(reps)} serve.replay spans, {len(launches)} "
            "cudaGraphLaunch calls: no clock mapping")
        return None
    x0 = reps[0]["start_ns"]
    x = np.array([(s["start_ns"] + s["end_ns"]) / 2 - x0 for s in reps],
                 np.float64)
    y = np.array([(h.start + h.end) / 2 for h in launches], np.float64)
    if len(x) > 1 and np.ptp(x) > 0:
        b, a = np.polyfit(x, y, 1)
    else:
        b, a = 1e-3, float(y[0] - 1e-3 * x[0])
    c = Clock(float(a), float(b), x0, 0.0)
    worst = max(max(c.us(s["start_ns"]) - h.start, h.end - c.us(s["end_ns"]))
                for s, h in zip(reps, launches))
    return c._replace(worst_us=max(0.0, float(worst)))


def copy_check_us(ctx):
    """The farthest any of serve()'s cudaMemcpyAsync calls (those inside
    a serve span) lies outside the nearest serve.copy_in /
    serve.copy_out span on the mapped clock (µs), or None."""
    c, spans = clock(ctx), window(ctx)
    if c is None:
        return None
    iv = intervals(spans, ("serve.copy_in", "serve.copy_out"), c)
    serves = intervals(spans, ("serve",), c)
    starts, tops = [a for a, _ in iv], [a for a, _ in serves]
    worst = 0.0
    for h in _calls(ctx.trace, "cudaMemcpyAsync"):
        j = bisect.bisect_right(tops, h.start) - 1
        if j < 0 or h.start > serves[j][1]:
            continue
        k = bisect.bisect_right(starts, h.start)
        near = [iv[j] for j in (k - 1, k) if 0 <= j < len(iv)]
        if not near:
            return None
        worst = max(worst, min(max(a - h.start, h.end - b, 0.0)
                               for a, b in near))
    return worst


def launched_in(ctx, names, skip=()) -> list:
    """[(launching call, device operation)] for each device operation
    whose launching CUDA call (by correlation id) falls inside a window
    span named in ``names``, on the mapped clock, those of calls named
    in ``skip`` left out; None without a mapping.  Only CUDA API calls
    (``cu*``) launch: the profiler's own host records (its buffer work)
    carry ids that are no correlation."""
    c = clock(ctx)
    if c is None:
        return None
    iv = intervals(window(ctx), names, c)
    starts = [a for a, _ in iv]
    calls = {}
    for h in ctx.trace.host:
        k = bisect.bisect_right(starts, h.start + TOL_US) - 1
        if h.corr and k >= 0 and h.end <= iv[k][1] + TOL_US \
                and h.name.startswith("cu") and h.name not in skip:
            calls[h.corr] = h
    return [(calls[o.corr], o) for o in ctx.trace.ops if o.corr in calls]


def intervals(spans, names, c: Clock) -> list:
    return sorted((c.us(s["start_ns"]), c.us(s["end_ns"]))
                  for s in spans if s["name"] in names)


@_memo
def serve_host(ctx):
    """Each window capture's ``serve`` span as (its µs, the µs of it
    inside the trace's host calls: the CUDA calls and the profiler's own
    buffer work), on the mapped clock; None without a mapping."""
    c = clock(ctx)
    if c is None:
        return None
    calls = sorted((h.start, h.end) for h in ctx.trace.host)
    starts = [a for a, _ in calls]
    out = []
    for a, b in intervals(window(ctx), ("serve",), c):
        inside, reach = 0.0, a
        for s, e in calls[max(0, bisect.bisect_right(starts, a) - 1):]:
            if s >= b:
                break
            lo, hi = max(s, reach), min(e, b)
            if hi > lo:
                inside += hi - lo
                reach = hi
        out.append((b - a, inside))
    return out


def setup_s(ctx, name: str):
    """Seconds in the program's set-up spans ``name``, the kernels' loads
    inside them (``setup.kernel_load``) left out; None where it kept no
    such span."""
    snap = snapshot(ctx)
    if not snap:
        return None
    setup = snap["setup"]
    mine = {s["index"] for s in setup if s["name"] == name and s["end_ns"]}
    if not mine:
        return None

    def under(s):
        p = s["parent"]
        while p >= 0:
            if p in mine:
                return True
            p = setup[p]["parent"]
        return False

    total = sum(s["end_ns"] - s["start_ns"] for s in setup
                if s["index"] in mine)
    loads = sum(s["end_ns"] - s["start_ns"] for s in setup
                if s["name"] == "setup.kernel_load" and s["end_ns"]
                and under(s))
    return (total - loads) / 1e9


def median(values):
    return statistics.median(values) if values else None
