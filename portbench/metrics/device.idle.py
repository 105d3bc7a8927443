"""Share (%) of the traced window in which no kernel, copy or memset
ran on the device: 1 - (the union of the device operations' times) over
(the first operation's start to the last's end), all from the trace.
CUPTI's tracing slows each graph launch on the host, so where the host
sets the pace (the replay) this reads more idle than an untraced run
would."""


def read(ctx):
    t = ctx.trace
    span = t.device_span_s
    return 100.0 * (1.0 - t.busy_s / span) if span > 0 else None
