"""Tracing and stage timing.

Port of rub_mimo_tpu/utils/profiling.py.  The reference's only
instrumentation is wall-clock stamps around its workers, printed as run
times and a bit rate (mimo/main.cc:49, 864, 900, 1024, 1133, 1462-1465).
Here:

  - ``trace(log_dir)``: a torch.profiler trace of the CPU and, where
    there is one, the CUDA device, written into log_dir as a Chrome
    trace (chrome://tracing, Perfetto);
  - ``StageTimer``: per-stage wall-clock time and IQ samples/s, each
    stage ended by a device synchronize (CUDA launches return before the
    device finishes);
  - ``annotate(name)``: a named span in that trace
    (torch.profiler.record_function).
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import time
from pathlib import Path
from typing import Dict, List

import torch


def _synchronize() -> None:
    """Wait for the device: a CUDA stage's launches return before it
    runs."""
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.synchronize()


@contextlib.contextmanager
def trace(log_dir: str):
    """Profile the block with torch.profiler (CPU, and CUDA where there
    is a device) and write log_dir/trace.json, a Chrome trace."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    out = Path(log_dir)
    out.mkdir(parents=True, exist_ok=True)
    with profile(activities=activities) as prof:
        yield
        _synchronize()
    prof.export_chrome_trace(str(out / "trace.json"))


def annotate(name: str):
    """A named span inside a trace (a context manager or decorator)."""
    return torch.profiler.record_function(name)


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

    @contextlib.contextmanager
    def stage(self, name: str, samples: int = 0):
        t0 = time.perf_counter()
        yield
        _synchronize()
        self.records.append(StageRecord(name, time.perf_counter() - t0,
                                        samples))

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

    def report(self) -> Dict:
        return {
            r.name: {
                "seconds": r.seconds,
                "samples": r.samples,
                "samples_per_second": r.samples_per_second,
            }
            for r in self.records
        }

    def to_json(self) -> str:
        return json.dumps(self.report(), indent=2)

    def print(self) -> None:
        for r in self.records:
            sps = (f"  {r.samples_per_second:.3e} samples/s" if r.samples
                   else "")
            print(f"    {r.name:<24}: {r.seconds * 1e3:8.3f} ms{sps}")
