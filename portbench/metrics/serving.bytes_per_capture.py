"""MB (1e6 bytes) a served capture copies eagerly around its graph: the
program's ``serve.bytes`` counter over its ``serve.captures``, counted
while the program recorded (the traced window).  None where the program
has no counters."""

from portbench import spans


def read(ctx):
    snap = spans.snapshot(ctx)
    if not snap or not snap["counters"].get("serve.captures"):
        return None
    c = snap["counters"]
    return c.get("serve.bytes", 0) / c["serve.captures"] / 1e6
