"""Tracing, spans and stage timing.

Port of rub_mimo_tpu/utils/profiling.py.  The reference's only
instrumentation is wall-clock stamps around its workers, printed as run
times and a bit rate (mimo/main.cc:49, 864, 900, 1024, 1133, 1462-1465).
Here:

  - ``trace(log_dir)``: a torch.profiler trace of the CPU and, where
    there is one, the CUDA device, written into log_dir as a Chrome
    trace (chrome://tracing, Perfetto), with the program's spans,
    counters and device marks, and the marks' stage µs, beside it
    (spans.json);
  - ``StageTimer``: per-stage wall-clock time and IQ samples/s, each
    stage ended by a device synchronize (CUDA launches return before the
    device finishes);
  - the span recorder: host spans of the served path, counters, set-up
    spans, and device stage marks inside the decode.

The recorder.  Host spans (name, start and end on ``time.perf_counter_ns``,
the parent span's index, the capture's sequence number) go into a ring
of RING entries that is allocated when spans first record; entries it
overwrites are counted as ``spans.dropped``.  Spans and counters record
while spans are on (``enable_spans``) or while a torch.profiler records
(as ``torch.profiler.record_function`` does); otherwise a site costs one
test and reads no clock.  The second switch is temporary: it is how a
benchmark harness that does not call ``enable_spans`` gets the spans of
its traced window, and it goes once the harness turns spans on itself.
It gives host spans and counters only, never device marks.  One sequence number is taken for each served
capture, at ``serve()``'s entry; that capture's spans carry it.
Set-up spans (``setup.*``: the serving graph's build, a kernel
library's load or build) happen a few times a process, never on the
served path, and are always kept, in a list that never wraps.

Device marks.  While spans are on, ``decode()`` launches a one-thread
kernel (csrc/span_mark.cu, ``span_mark_<mark>``) at each of its stage
bounds (MARKS).  It writes (sequence number, mark, %globaltimer ns) into
a device ring; ``decode.begin`` increments the device's sequence word,
which counts marked decodes as the host's sequence numbers count served
captures, so a served capture's marks carry its number while spans stay
on from its graph's capture.  A graph holds the marks only if spans were
on when it was captured; with spans off it has no mark node.  In a
profiler trace the marks are kernels; ``device_stages()`` reads the ring
without one.  Nothing here issues a CUDA event record.

``spans_snapshot()`` returns everything recorded, and is the one way to
read it: nothing is written while a window runs.
"""

from __future__ import annotations

import contextlib
import ctypes
import dataclasses
import functools
import json
import time
from pathlib import Path
from typing import List

import torch
import torch.autograd.profiler as _torch_profiler

_clock = time.perf_counter_ns

RING = 1 << 16  # host spans kept: ~2 s of served captures at 6 spans each
MARK_RING = 1 << 16  # device marks kept a card: 9,362 captures of 7
# decode()'s stage bounds, in launch order; stage k runs from mark k - 1
# to mark k
MARKS = ("decode.begin", "complex", "sync", "timing", "channel", "window",
         "decode.end")
STAGES = ("complex", "sync", "timing", "channel", "window", "tail")

_on = False  # enable_spans()
_no_marks = 0  # depth of no_marks() blocks


def _synchronize() -> None:
    """Wait for the device: a CUDA stage's launches return before it
    runs."""
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.synchronize()


class Recorder:
    """The host spans, set-up spans and counters of this process."""

    def __init__(self, size: int = RING):
        self.size = size
        self.name = None  # the ring's columns, allocated at first use
        self.n = 0  # spans begun, ever (a span's index)
        self.open = -1  # index of the innermost open span
        self.seq = 0  # the current capture's sequence number
        self.counters = {}
        self.setup = []  # [name, detail, start, end, parent, seq]
        self.setup_open = -1

    def allocate(self) -> "Recorder":
        if self.name is None:
            n = self.size
            self.name, self.start, self.end = [None] * n, [0] * n, [0] * n
            self.parent, self.seqs = [-1] * n, [0] * n
        return self

    def next_seq(self) -> int:
        self.seq += 1
        return self.seq

    def begin(self, name: str) -> int:
        i = self.n
        k = i % self.size
        self.n = i + 1
        self.name[k] = name
        self.parent[k] = self.open
        self.seqs[k] = self.seq
        self.end[k] = 0
        self.open = i
        self.start[k] = _clock()
        return i

    def finish(self, i: int) -> None:
        """End span i; spans left open inside it (an exception) stay
        open, and the innermost open span is i's parent again."""
        t = _clock()
        k = i % self.size
        if self.n - i <= self.size:
            self.end[k] = t
            self.open = self.parent[k]
        else:
            self.open = -1

    def add(self, name: str, value: int = 1) -> None:
        self.counters[name] = self.counters.get(name, 0) + value

    def copied(self, nbytes: int) -> None:
        """One eager copy of the served path: ``serve.copies`` and
        ``serve.bytes``."""
        self.add("serve.copies")
        self.add("serve.bytes", nbytes)


REC = Recorder()


def enable_spans() -> None:
    """Turn spans, counters and device marks on."""
    global _on
    _on = True
    REC.allocate()


def disable_spans() -> None:
    global _on
    _on = False


def recording():
    """The recorder while spans are on or a torch.profiler records, else
    None."""
    if _on or _torch_profiler._is_profiler_enabled:
        return REC.allocate()
    return None


def copied_by_as_tensor(given, t: torch.Tensor) -> bool:
    """Whether ``torch.as_tensor(given, ...)`` made ``t`` by a copy: it
    moved ``given`` to another device or converted its dtype (a tensor
    or a CPU array it could share is not copied)."""
    if torch.is_tensor(given):
        return given.data_ptr() != t.data_ptr() or given.device != t.device
    ptr = getattr(given, "__array_interface__", {}).get("data", (None,))[0]
    return t.device.type != "cpu" or ptr != t.data_ptr()


def count(name: str, value: int = 1) -> None:
    """A counter that moves whether or not spans are on (set-up events,
    a few a process)."""
    REC.add(name, value)


@contextlib.contextmanager
def setup_span(name: str, detail: str | None = None):
    """A set-up span (kept whether or not spans are on)."""
    rec = [name, detail, _clock(), 0, REC.setup_open, REC.seq]
    REC.setup.append(rec)
    outer, REC.setup_open = REC.setup_open, len(REC.setup) - 1
    try:
        yield
    finally:
        rec[3] = _clock()
        REC.setup_open = outer


# ---- device marks ----------------------------------------------------


@functools.lru_cache(maxsize=None)
def _mark_fn():
    from rub_mimo_tpu_torch.kernels import _build

    fn = _build.load("span_mark").span_mark
    P, I = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = [I, P, P, I, P]
    fn.restype = I
    return fn


class DeviceMarks:
    """One card's mark ring [MARK_RING, 3] int64 (sequence number, mark,
    ns) and its words (sequence number, marks written)."""

    launches = 0

    def __init__(self, device: torch.device):
        self.device = device
        self.ring = torch.zeros((MARK_RING, 3), dtype=torch.int64,
                                device=device)
        self.word = torch.zeros(2, dtype=torch.int64, device=device)
        self.fn = _mark_fn()

    def __call__(self, mark: int) -> None:
        with torch.cuda.device(self.device):
            err = self.fn(mark, self.ring.data_ptr(), self.word.data_ptr(),
                          MARK_RING,
                          torch.cuda.current_stream(self.device).cuda_stream)
        if err != 0:
            raise RuntimeError(f"span_mark launch failed: CUDA error {err}")
        DeviceMarks.launches += 1

    def read(self) -> tuple:
        """(marks [(seq, mark, ns)] oldest first, marks overwritten);
        synchronizes the card."""
        torch.cuda.synchronize(self.device)
        ring = self.ring.cpu().tolist()
        written = int(self.word[1].item())
        k = written % MARK_RING
        rows = ring[:written] if written <= MARK_RING else ring[k:] + ring[:k]
        return rows, max(0, written - MARK_RING)


_device_marks = {}  # card index -> DeviceMarks


def _no_mark(mark: int) -> None:
    pass


def marker(device: torch.device):
    """decode()'s mark launcher on ``device``: a DeviceMarks while spans
    are on and it is a card, else a function that does nothing.  An
    eager decode's marks take the next sequence number (a graph's replay
    takes its capture's).  The card's ring is made at its first call,
    inside no_marks() too: a graph's warm decodes make it before its
    capture."""
    if not _on or device.type != "cuda":
        return _no_mark
    idx = device.index if device.index is not None \
        else torch.cuda.current_device()
    marks = _device_marks.get(idx)
    if marks is None:
        marks = _device_marks[idx] = DeviceMarks(torch.device("cuda", idx))
    if _no_marks:
        return _no_mark
    if not torch.cuda.is_current_stream_capturing():
        REC.allocate().next_seq()
    return marks


@contextlib.contextmanager
def no_marks():
    """Decodes in the block launch no marks (a graph's warm decodes)."""
    global _no_marks
    _no_marks += 1
    try:
        yield
    finally:
        _no_marks -= 1


# ---- reading ------------------------------------------------------------


def spans_snapshot() -> dict:
    """Everything recorded: host spans (the ring's, oldest first),
    set-up spans, counters (with ``spans.dropped`` and
    ``marks.dropped``) and the device marks (each card synchronized).
    Times are ``time.perf_counter_ns`` (host) and %globaltimer ns
    (device); an open span's end is None."""
    spans = []
    if REC.name is not None:
        for i in range(max(0, REC.n - REC.size), REC.n):
            k = i % REC.size
            spans.append({"index": i, "name": REC.name[k],
                          "start_ns": REC.start[k],
                          "end_ns": REC.end[k] or None,
                          "parent": REC.parent[k], "seq": REC.seqs[k]})
    setup = [{"index": i, "name": s[0], "detail": s[1], "start_ns": s[2],
              "end_ns": s[3] or None, "parent": s[4], "seq": s[5]}
             for i, s in enumerate(REC.setup)]
    marks, dropped = [], 0
    for idx, dm in sorted(_device_marks.items()):
        rows, d = dm.read()
        dropped += d
        marks += [{"device": idx, "seq": s, "mark": MARKS[m], "ns": t}
                  for s, m, t in rows]
    counters = dict(REC.counters)
    counters["spans.dropped"] = max(0, REC.n - REC.size)
    counters["marks.dropped"] = dropped
    return {"clock": "time.perf_counter_ns", "spans": spans,
            "setup": setup, "counters": counters, "marks": marks}


def device_stages(marks=None) -> list:
    """Each marked decode's stage µs from the device marks (read from the
    rings when not given): [{"device", "seq", "stages_us": {stage: µs},
    "gap_us"}], ``gap_us`` the device time from the previous decode's
    ``decode.end`` to this one's ``decode.begin`` on the card (None for a
    card's first): the card's idle between two graphs, read without a
    profiler.  Decodes missing a mark are left out."""
    if marks is None:
        marks = spans_snapshot()["marks"]
    by = {}
    for m in marks:
        by.setdefault((m["device"], m["seq"]), {})[m["mark"]] = m["ns"]
    out, last_end = [], {}
    for (dev, seq), t in sorted(by.items()):
        if len(t) != len(MARKS):
            continue
        prev = last_end.get(dev)
        out.append({"device": dev, "seq": seq,
                    "stages_us": {s: (t[MARKS[k + 1]] - t[MARKS[k]]) / 1e3
                                  for k, s in enumerate(STAGES)},
                    "gap_us": None if prev is None
                    else (t["decode.begin"] - prev) / 1e3})
        last_end[dev] = t["decode.end"]
    return out


# ---- the operator's trace ----------------------------------------------

@contextlib.contextmanager
def trace(log_dir: str):
    """Profile the block with torch.profiler (CPU, and CUDA where there
    is a device) and write log_dir/trace.json, a Chrome trace, with spans
    on; beside it log_dir/spans.json, ``spans_snapshot()`` on its own
    clocks with each marked decode's ``device_stages()``.  The marks
    themselves are in trace.json too, as ``span_mark_<mark>`` kernels on
    the trace's clock."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    out = Path(log_dir)
    out.mkdir(parents=True, exist_ok=True)
    was_on = _on
    enable_spans()
    try:
        with profile(activities=activities) as prof:
            yield
            _synchronize()
    finally:
        if not was_on:
            disable_spans()
    prof.export_chrome_trace(str(out / "trace.json"))
    snap = spans_snapshot()
    snap["device_stages"] = device_stages(snap["marks"])
    (out / "spans.json").write_text(json.dumps(snap, indent=1))


@dataclasses.dataclass
class StageRecord:
    name: str
    seconds: float
    samples: int = 0

    @property
    def samples_per_second(self) -> float:
        return self.samples / self.seconds if self.seconds > 0 else 0.0


class StageTimer:
    """Wall-clock stage timer with IQ-samples/s accounting; each stage
    ends with a device synchronize, so its time holds its device work."""

    def __init__(self):
        self.records: List[StageRecord] = []

    def time_stage(self, name: str, fn, *args, samples: int = 0,
                   iters: int = 1):
        """Run fn(*args) once to warm up, then `iters` times; record the
        best and return the last output."""
        out = fn(*args)
        _synchronize()
        best = float("inf")
        for _ in range(iters):
            t0 = time.perf_counter()
            out = fn(*args)
            _synchronize()
            best = min(best, time.perf_counter() - t0)
        self.records.append(StageRecord(name, best, samples))
        return out

    def print(self) -> None:
        for r in self.records:
            sps = (f"  {r.samples_per_second:.3e} samples/s" if r.samples
                   else "")
            print(f"    {r.name:<24}: {r.seconds * 1e3:8.3f} ms{sps}")
