#!/usr/bin/env python3
"""One run of a benchmark cell (portbench/) with the program's spans
switched on or off from the start, on one NVIDIA GPU.

    python3 scripts/trace_served.py --workload ref2x2.replay --seed 7 \
        --seconds 15 --trace 0 --spans on

``--spans on`` calls ``profiling.enable_spans()`` before the serving
decoder is built, so its graph holds the decode's device marks and every
capture records its host spans; ``off`` leaves the switch off (a traced
window still records host spans, as the benchmark's does).  Prints the
benchmark's result line with these extra metrics (beside its own):

  - ``serve.host_us_timed``: the median host µs of a ``serve()`` call
    over the window's captures, timed around the call by this script
    (the same clock with spans on or off, so it gives the recorder's
    own cost);
  - with spans on: ``marks.<stage>_us`` and ``marks.gap_us``, medians
    over the window's captures of ``profiling.device_stages()`` (the
    device marks' ring, no profiler), and ``spans.<span>_us``, the
    median of each served span (``serve`` and its children);
  - traced with spans on: ``estimate.<stage>_us``, the estimation
    layer's device µs a capture by the decode stage between the two
    marks that bracket each operation (``estimate_split``; the rest, the
    marks' own kernels among it, goes to standard error, so that the
    four and the rest add up to ``estimate.device_us``), and
    ``marks.device_us``, the marks' own device µs a capture.

Exits 2 without a GPU, as portbench/run.py does.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import statistics  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
MARK = "span_mark_"
# the stage that begins at each mark (utils/profiling.py MARKS, STAGES)
AFTER = {"begin": "complex", "complex": "sync", "sync": "timing",
         "timing": "channel", "channel": "window", "window": "tail",
         "end": None}
ESTIMATE_STAGES = ("complex", "timing", "channel", "window")


def estimate_split(t):
    """Device µs a capture of the trace ``t``'s estimation-layer
    operations by the decode stage they ran in (between two device
    marks): {stage: µs}, with "outside" for those before a capture's
    first mark or after its last and "marks" for the marks' own kernels
    (no layer claims them); None where the trace holds no mark.  Said on
    standard error: what falls outside the four estimation stages."""
    from portbench.trace import short_name

    split, marks, stage = {}, 0, None
    for o in sorted(t.ops, key=lambda o: o.start):
        name = short_name(o.name)
        if name.startswith(MARK):
            marks += 1
            stage = AFTER.get(name[len(MARK):])
            k = "marks"
        else:
            k = stage or "outside"
        if t.layer_of(o) == "estimate":
            split[k] = split.get(k, 0.0) + o.end - o.start
    if not marks or not t.captures:
        return None
    out = {k: v / t.captures for k, v in split.items()}
    if marks != 7 * t.captures:
        print(f"trace_served: {marks} device marks for {t.captures} "
              f"captures ({7 * t.captures} expected)", file=sys.stderr)
    rest = {k: v for k, v in out.items() if k not in ESTIMATE_STAGES}
    print("trace_served: estimation outside its four stages (us a "
          "capture): " + (", ".join(f"{k} {v:.3f}" for k, v in
                                    sorted(rest.items())) or "none"),
          file=sys.stderr)
    return out


def _extras(timed: list, spans_on: bool):
    from portbench.trace import short_name
    from rub_mimo_tpu_torch.utils import profiling

    def serve_timed(ctx):
        n = ctx.window["completed"]
        return statistics.median(timed[-n:]) if n else None

    def marks(ctx):
        n = ctx.window["completed"]
        got = profiling.device_stages()[-n:]
        if not got:
            return None
        out = {f"marks.{s}_us": statistics.median(
            g["stages_us"][s] for g in got) for s in profiling.STAGES}
        gaps = [g["gap_us"] for g in got if g["gap_us"] is not None]
        out["marks.gap_us"] = statistics.median(gaps) if gaps else None
        return out

    def serve_spans(ctx):
        snap = profiling.spans_snapshot()
        n = ctx.window["completed"]
        out = {}
        for name in ("serve", "serve.prepare", "serve.copy_in",
                     "serve.replay", "serve.copy_out"):
            d = [(s["end_ns"] - s["start_ns"]) / 1e3 for s in snap["spans"]
                 if s["name"] == name and s["end_ns"]][-n:]
            if d:
                out[f"spans.{name}_us"] = statistics.median(d)
        return out or None

    def timeline(ctx):
        """The device operations of the window's middle capture, from its
        decode.begin mark on, to standard error."""
        t = ctx.trace
        ops = sorted(t.ops, key=lambda o: o.start)
        begins = [i for i, o in enumerate(ops) if MARK + "begin" in o.name]
        if not begins:
            return None
        i = begins[len(begins) // 2]
        t0 = ops[i].start
        for o in ops[i:]:
            print(f"timeline {o.start - t0:9.2f} {o.end - o.start:8.2f} "
                  f"{short_name(o.name)}", file=sys.stderr)
            if MARK + "end" in o.name:
                break
        return None

    def marks_device(ctx):
        t = ctx.trace
        return sum(o.end - o.start for o in t.kernels([MARK])) \
            / t.captures if t.captures else None

    readers = {"serve.host_us_timed": serve_timed}
    if spans_on:
        readers.update({"marks": marks, "spans": serve_spans})
        split = {}

        def stage_us(s):
            def read(ctx):
                if "v" not in split:
                    split["v"] = estimate_split(ctx.trace)
                return None if split["v"] is None else split["v"].get(s, 0.0)
            return read
        readers_traced = {f"estimate.{s}_us": stage_us(s)
                          for s in ESTIMATE_STAGES}
        readers_traced["marks.device_us"] = marks_device
        readers_traced["timeline"] = timeline
    else:
        readers_traced = {}
    return readers, readers_traced


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--spans", choices=("on", "off"), required=True)
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    from portbench import harness, run
    from portbench.registry import Registry
    from rub_mimo_tpu_torch.pipeline import rx
    from rub_mimo_tpu_torch.utils import profiling

    for var, sub in run.CACHES.items():
        os.environ[var] = str(ROOT / ".portbench_cache" / sub)
    timed = []
    make = rx.make_serving_decoder

    def make_timed(*a, **k):
        serve = make(*a, **k)

        def timed_serve(*x):
            t0 = time.perf_counter_ns()
            out = serve(*x)
            timed.append((time.perf_counter_ns() - t0) / 1e3)
            return out
        return timed_serve

    rx.make_serving_decoder = make_timed
    spans_on = args.spans == "on"
    if spans_on:
        profiling.enable_spans()
    readers, traced = _extras(timed, spans_on)
    extra = dict(readers, **(traced if args.trace else {}))

    class WithExtras(Registry):
        def metrics(self, cell, trace):
            return super().metrics(cell, trace) + [
                {"name": k, "unit": "us"} for k in extra]

        def reader(self, metric):
            return extra.get(metric) or super().reader(metric)

    try:
        out = harness.run_cell(args.workload, args.seed, args.seconds,
                               bool(args.trace), t_start=T_START,
                               registry=WithExtras())
    except harness.NoResult as e:
        print(f"trace_served: {e}", file=sys.stderr)
        return 2
    m = out["metrics"]
    for group in ("marks", "spans"):
        if group in m:
            m.update({k: {"value": v, "unit": "us"}
                      for k, v in m.pop(group)["value"].items()})
    out["spans"] = args.spans
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
