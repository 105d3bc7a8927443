"""One run of one cell: set-up, the measured window, the readers, the
check against the configuration's plain receiver.

The window is a closed loop over the pool: the host serves capture n
(pool index n mod pool size) as soon as capture n - in_flight has
finished on the device, so at most ``in_flight`` captures are queued
ahead of the card.  Each capture's latency is the device time between a
CUDA event recorded before its input copy and one recorded after its
last output.  The window ends at the first capture the host would serve
after ``seconds``; a synchronize then ends its wall time.  A sample of
the answers, drawn from the seed (a reservoir), is kept for the check.
"""

from __future__ import annotations

import collections
import gc
import random
import sys
import time
from types import SimpleNamespace

import torch

from portbench import compare, pool as pool_mod
from portbench.registry import Registry
from portbench.trace import Trace

FORBIDDEN = ("jax", "jaxlib", "flax", "rub_mimo_tpu")
WARM_CAPTURES = 8  # served after the graph's capture, before the window
TRACE_SECONDS = 2.0  # the traced window's length at most


class NoResult(RuntimeError):
    """A run that must print no result (and exit with another code)."""


class CudaClock:
    """Device time of each capture from two CUDA events, taken from a
    ring that outlasts the captures in flight (made once: an event made
    a capture would be host work inside the window)."""

    def __init__(self, in_flight: int):
        self.stream = torch.cuda.current_stream()
        self.ring = [torch.cuda.Event(enable_timing=True)
                     for _ in range(2 * (in_flight + 1))]
        self.next = 0
        self.bound = torch.cuda.Event()

    def stage_mark(self):
        """A record between two stages of a capture's path: never read,
        it marks in the trace where the next stage's launches begin."""
        self.bound.record(self.stream)

    def mark(self):
        ev = self.ring[self.next]
        self.next = (self.next + 1) % len(self.ring)
        ev.record(self.stream)
        return ev

    @staticmethod
    def wait(mark):
        mark.synchronize()

    @staticmethod
    def ms(a, b) -> float:
        return a.elapsed_time(b)

    @staticmethod
    def sync():
        torch.cuda.synchronize()


class HostClock:
    """The same interface on the CPU, where a call returns when done."""

    mark = staticmethod(time.perf_counter)

    @staticmethod
    def stage_mark():
        pass

    @staticmethod
    def wait(mark):
        pass

    @staticmethod
    def ms(a, b) -> float:
        return (b - a) * 1e3

    @staticmethod
    def sync():
        pass


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is jax, jaxlib, flax or the
    JAX package (names compared whole: the port's name begins with the
    JAX package's)."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def window(path, pool, seconds: float | None, in_flight: int, keep: int,
           rng: random.Random, clock, count: int | None = None) -> dict:
    """The closed loop for ``seconds`` (or for ``count`` captures):
    completed captures, wall seconds, every capture's latency (ms), the
    pool index of each capture and a reservoir of ``keep`` answers
    [(request, pool index, answer)]."""
    views = pool.views
    P = len(views)
    queue = collections.deque()
    lat, idx, kept = [], [], []
    clock.sync()
    t0 = time.perf_counter()
    n = 0
    while (n < count if count is not None
           else time.perf_counter() - t0 < seconds):
        if len(queue) == in_flight:
            a, b = queue.popleft()
            clock.wait(b)
            lat.append(clock.ms(a, b))
        i = n % P
        a = clock.mark()
        out = path(*views[i])
        b = clock.mark()
        queue.append((a, b))
        idx.append(i)
        if len(kept) < keep:
            kept.append((n, i, out))
        elif keep:
            j = rng.randrange(n + 1)
            if j < keep:
                kept[j] = (n, i, out)
        n += 1
    clock.sync()
    wall = time.perf_counter() - t0
    lat += [clock.ms(a, b) for a, b in queue]
    return {"completed": n, "wall_s": wall, "latencies_ms": lat,
            "pool_indices": idx, "kept": kept}


def check_device(chips: int) -> dict:
    if not torch.cuda.is_available():
        raise NoResult("no CUDA device: this benchmark runs on an NVIDIA "
                       "GPU only")
    if torch.cuda.device_count() < chips:
        raise NoResult(f"the cell needs {chips} GPUs, "
                       f"{torch.cuda.device_count()} found")
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": chips}


def run_cell(cell_name: str, seed: int, seconds: float, trace: bool, *,
             t_start: float, registry: Registry | None = None,
             device: str = "cuda", make_path=None,
             captures: int | None = None) -> dict:
    """One run; returns the result line (a dict).  ``make_path(config,
    device)`` builds the timed path (the program's served decode unless
    given); ``device="cpu"`` runs without the look for a card and
    ``captures`` serves that many captures in an untraced window in
    place of ``seconds`` (tests)."""
    reg = registry or Registry()
    cell = reg.cell(cell_name)
    config = reg.config(cell["config"])
    traffic = reg.traffic(cell["traffic"])
    try:
        rcv = reg.receiver(config)
    except KeyError as e:
        raise NoResult(e.args[0]) from e
    md = rcv.Modem(config["modem"])
    limits = config["limits"]
    coded = bool(config.get("fec"))
    if device == "cuda":
        dev_info = check_device(cell["chips"])
        clock = CudaClock(traffic["in_flight"])
    else:
        dev_info = {"platform": "cpu", "kind": "cpu", "count": 1}
        clock = HostClock()
    if make_path is None:
        from portbench import program
        make_path = program.make

    # the message bits are the generator's truth, which the check does
    # not read: it holds the program to the plain receiver
    pool = pool_mod.make(md, traffic, seed, device, coded)._replace(msg=None)
    if device == "cuda":
        torch.cuda.reset_peak_memory_stats()
    path = make_path(config, device)
    if hasattr(path, "mark"):
        path.mark = clock.stage_mark
    rng = random.Random(seed)
    keep = traffic["check_sample"]
    depth = traffic["in_flight"]
    # the warm captures hold as many answers as the window's sample will,
    # so that the window's kept answers find their memory in the
    # allocator's cache (no cudaMalloc inside the window)
    window(path, pool, None, depth, keep, random.Random(~seed), clock,
           count=max(WARM_CAPTURES, keep + depth))
    setup_s = time.perf_counter() - t_start

    gc.collect()
    gc.disable()
    try:
        if trace:
            res, tr = traced_window(path, pool, min(seconds, TRACE_SECONDS),
                                    depth, keep, rng, clock, reg,
                                    getattr(path, "stages", ("decode",)))
        else:
            res = window(path, pool, seconds, depth, keep, rng, clock,
                         count=captures)
            tr = None
    finally:
        gc.enable()
    if device == "cuda":
        dev_info["memory_peak_bytes"] = torch.cuda.max_memory_allocated()
    bad = forbidden_modules()
    if bad:
        raise NoResult(f"modules of JAX or the JAX package are loaded: {bad}")

    T = traffic["capture_samples"]
    refs = compare.reference_answers(pool, [i for _, i, _ in res["kept"]],
                                     rcv, md, limits)
    answer = getattr(path, "answer", lambda out: out)
    kept = [(n, i, answer(out)) for n, i, out in res["kept"]]
    verdict = compare.judge(kept, refs, rcv, md, limits, T, coded)
    del path, kept
    t_star = {}
    if tr is not None:  # K5's bound needs each traced capture's t*
        f64 = rcv.Precision("float64")
        t_star = {i: refs[i]["t_star"] if i in refs else rcv.synchronize(
                      f64(pool.capture(i)), md, f64)["t_star"]
                  for i in set(tr.pool_indices)}
    ctx = SimpleNamespace(registry=reg, cell=cell, config=config,
                          traffic=traffic, md=md, window=res,
                          setup_s=setup_s, trace=tr,
                          t_star=t_star,
                          samples_per_capture=md.S * T)
    metrics = {}
    for m in reg.metrics(cell_name, trace):
        v = reg.reader(m["name"])(ctx)
        if v is not None:
            metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    out = {"correct": verdict["correct"], "attempted": res["completed"],
           "failed": verdict["failed"], "metrics": metrics,
           "device": dev_info}
    if tr is not None:
        out["device"].update(busy_s=tr.busy_s, window_s=tr.window_s)
        out["breakdown"] = tr.breakdown()
    out["checks"] = verdict["checks"]
    return out


def traced_window(path, pool, seconds, depth, keep, rng, clock, reg,
                  stages=("decode",)):
    """The window under torch.profiler; returns (window result, Trace).
    ``stages``: the names of the path's stages, in order."""
    from torch.profiler import ProfilerActivity, profile, schedule

    layers = reg.layers()
    names = {}
    for v in layers.values():
        names.update(v.get("counters", {}))
    counters = _counters(names)
    with profile(activities=[ProfilerActivity.CUDA],
                 schedule=schedule(wait=0, warmup=1, active=1,
                                   repeat=1)) as prof:
        window(path, pool, None, depth, 0, rng, clock, count=2 * depth)
        prof.step()
        before = counters()
        res = window(path, pool, seconds, depth, keep, rng, clock)
        after = counters()
        prof.step()
    tr = Trace.from_profiler(prof, layers, res["pool_indices"],
                             {k: after[k] - before[k] for k in after},
                             res["wall_s"], stages)
    return res, tr


def _counters(names: dict):
    if not names:
        return lambda: {}
    from portbench import program
    return lambda: program.counters(names)

