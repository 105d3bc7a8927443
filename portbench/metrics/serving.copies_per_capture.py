"""Eager copies a served capture makes around its graph (a stack that
``torch.as_tensor`` moves or converts, the inputs in, the outputs out):
the program's ``serve.copies`` counter, which counts each copy where it
is issued, over its ``serve.captures``, counted while the program
recorded (the traced window).  On standard error, beside it: the device
operations a capture that calls inside the program's ``serve`` spans
launched, the graph's launch left out (a copy of a non-contiguous field
is a copy kernel, not a memcpy: both count), so that any other eager
operation of ``serve()`` shows; a graph captured inside the window
(``serve.graph_captures``).  None where the program has no counters."""

import collections

from portbench import spans


def read(ctx):
    snap = spans.snapshot(ctx)
    if not snap or not snap["counters"].get("serve.captures"):
        return None
    c = snap["counters"]
    n = c.get("serve.copies", 0) / c["serve.captures"]
    t = ctx.trace
    ops = spans.launched_in(ctx, ("serve",), skip=("cudaGraphLaunch",)) \
        if t is not None and t.captures else None
    if ops is not None:
        seen = len(ops) / t.captures
        memcpy = sum(o.name.startswith("Memcpy") for _, o in ops) \
            / t.captures
        by = collections.Counter(h.name for h, _ in ops)
        spans.say(f"serving.copies_per_capture: {n} by the counter; "
                  f"{seen} device operations a capture launched inside serve "
                  f"spans outside the graph, {memcpy} of them memcpy; by "
                  "call: " + ", ".join(f"{k} {v / t.captures}"
                                       for k, v in sorted(by.items())))
        clk = spans.clock(ctx)
        spans.say(f"clock mapping: graph launches at most "
                  f"{clk.worst_us:.3f} us outside their serve.replay spans; "
                  f"serve()'s memcpy calls at most {spans.copy_check_us(ctx)}"
                  " us outside their copy spans")
        inside = [s for s in snap["setup"] if s["name"] == "setup.graph"
                  and t.window.start <= clk.us(s["start_ns"])
                  <= t.window.end]
        if inside:
            spans.say(f"{len(inside)} serving graphs captured inside the "
                      "traced window")
    return n
