"""Host µs of a served capture that are ``serve()``'s own: the median,
over the traced window's captures, of the program's ``serve`` span less
the time inside it that the trace records as host calls (the CUDA calls
and the profiler's buffer work).  The profiler lengthens each CUDA call
(a graph launch ~280 µs traced against 11–21 untraced), so the whole
span measures mostly the profiler; what is left is the Python work: the
stacks, the graph's lookup, the outputs' allocation, the copies' and
the launch's dispatch.  The whole span's median and the calls' share go
to standard error.  None where the program records no spans."""

from portbench import spans


def read(ctx):
    got = spans.serve_host(ctx)
    if not got:
        return None
    whole = spans.median([s for s, _ in got])
    calls = spans.median([c for _, c in got])
    spans.say(f"serving.host_us: serve spans {whole:.3f} us (median), "
              f"{calls:.3f} us of them in the trace's host calls")
    return spans.median([s - c for s, c in got])
