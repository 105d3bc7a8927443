"""Device µs a capture of the serving layer's copies and memsets (the
input into the graph's buffers, the outputs out of them, K5's counters'
memset) in the traced window."""


def read(ctx):
    t = ctx.trace
    return t.layer_seconds("serving") * 1e6 / t.captures if t.captures \
        else None
