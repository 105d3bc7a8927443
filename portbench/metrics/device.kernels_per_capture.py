"""Kernel launches (copies and memsets not counted) a capture in the
traced window.  A kernel that a wrapper launches eagerly is counted by
the wrapper's launch counter (its moves over the window; a graph's
replay calls no wrapper, so the graph's kernels come from the trace);
where the trace holds another number of it (CUPTI can drop a record),
that is said on standard error."""

import sys


def read(ctx):
    t = ctx.trace
    if not t.captures:
        return None
    n = len(t.kernels())
    for name, delta in t.counter_deltas.items():
        seen = len(t.kernels([name]))
        if delta and seen != delta:
            print(f"device.kernels_per_capture: {name} launched {delta} "
                  f"times by its counter, {seen} in the trace",
                  file=sys.stderr)
        n += delta - seen if delta else 0
    return n / t.captures
