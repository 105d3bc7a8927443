"""IQ samples (streams x capture length) of every capture completed in
the window, over the window's wall time (ended by a synchronize), in
millions a second."""


def read(ctx):
    w = ctx.window
    return w["completed"] * ctx.samples_per_capture / w["wall_s"] / 1e6
