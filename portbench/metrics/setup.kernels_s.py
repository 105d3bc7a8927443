"""Seconds of set-up in loading the program's kernel libraries
(``setup.kernel_load``, nvcc's build included where it ran), wherever
they happened before the window.  None where the program keeps no
set-up spans."""

from portbench import spans


def read(ctx):
    snap = spans.snapshot(ctx)
    if not snap:
        return None
    loads = [s for s in snap["setup"] if s["name"] == "setup.kernel_load"
             and s["end_ns"]]
    if not loads:
        return None
    return sum(s["end_ns"] - s["start_ns"] for s in loads) / 1e9
