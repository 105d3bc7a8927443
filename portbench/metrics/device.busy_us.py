"""Device µs a capture in which some kernel, copy or memset ran (the
union of the traced window's device operations over its captures): the
card's own work a capture, without the idle time between operations
that sets the window's pace."""


def read(ctx):
    t = ctx.trace
    return t.busy_s * 1e6 / t.captures if t.captures else None
