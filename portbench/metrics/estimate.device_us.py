"""Device µs a capture of the estimation layer (the matched filter, LS,
the detector weights, the windows: every operation that no other layer
claims by its stage or its name patterns) in the traced window."""


def read(ctx):
    t = ctx.trace
    return t.layer_seconds("estimate") * 1e6 / t.captures if t.captures \
        else None
