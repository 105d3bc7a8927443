#!/usr/bin/env python3
"""What sets K6's pace on one NVIDIA GPU: ablation and variant builds of
rub_mimo_tpu_torch/kernels/csrc/sc_metric.cu, timed in turns with the
kernel as it stands.

    python3 scripts/ablate_k6.py [--calls 10]

Each variant is the kernel's source with a few lines replaced (a missing
line stops the script), built with the port's nvcc flags into
rub_mimo_tpu_torch/_build/ablate_k6/ and called through the same C
interface:

- ``no_copies``: the chunks' copies after a span's first are skipped
  (the ring keeps stale samples);
- ``no_lag_reads``: the lag products use the sample itself, not x[j - M/2];
- ``no_stores``: the metric is computed but not stored;
- ``no_outputs``: no output phase;
- ``prefix_only``: no output phase and no prefix sums stored;
- ``prefix_only_no_copies``: both;
- ``threads_512``: 512 threads up to M = 2048 too (C = 8192 - M, one
  block per SM).

The ablations' outputs are wrong by design; the kernel and the full
variant are first held against ``sc_metric_reference`` by
``chip_smoke.check_metric`` on the three shapes of scripts/time_k6.py.
Then torch.profiler's busy time per call
(median of ``--calls``) at the three shapes, each variant twice, in the
order given and back.  Prints the card line, then one JSON line.  Exits
non-zero without a CUDA device, on a failed build or on a mismatch."""

from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
from pathlib import Path

import torch

REPO = Path(__file__).resolve().parents[1]
OUT = REPO / "rub_mimo_tpu_torch" / "_build" / "ablate_k6"

NO_COPIES = [("    if (more) {\n      const float2* xs",
              "    if (false) {\n      const float2* xs")]
NO_OUTPUTS = [("    const int n_out = min(C, T - c0);",
               "    const int n_out = 0;\n"
               "    if (tid == 0 && oR == 1.2345e-30f) out[0] = oR;")]
NO_PREFIX_STORES = [
    ("      pb[u] = make_float2(pr[u] + oR, pi[u] + oI);\n"
     "      eb[u] = en[u] + oE;",
     "      if (pr[u] + oR == 1.2345e-30f) {\n"
     "        pb[u] = make_float2(pi[u] + oI, en[u] + oE);\n      }")]
# name -> (replacements, held to the plain version)
VARIANTS = {
    "kernel": ([], True),
    "no_copies": (NO_COPIES, False),
    "no_lag_reads": ([("const float2 a = ra[u];", "const float2 a = b;")],
                     False),
    "no_stores": ([("      out[i] = m;",
                    "      if (m == 1.2345e-30f) out[i] = m;")], False),
    "no_outputs": (NO_OUTPUTS, False),
    "prefix_only": (NO_OUTPUTS + NO_PREFIX_STORES, False),
    "prefix_only_no_copies": (NO_OUTPUTS + NO_PREFIX_STORES + NO_COPIES,
                              False),
    "threads_512": ([("M <= 2048 ? 256 : 512", "512")], True),
}


def write_source(name: str, csrc: Path) -> Path:
    """The variant's source under OUT."""
    src = (csrc / "sc_metric.cu").read_text()
    for old, new in VARIANTS[name][0]:
        if src.count(old) != 1:
            raise SystemExit(f"{name}: the source no longer has {old!r}")
        src = src.replace(old, new)
    cu = OUT / f"{name}.cu"
    cu.write_text(src)
    return cu


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--calls", type=int, default=10)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("ablate_k6.py: no CUDA device")
    sys.path.insert(0, str(REPO))
    from chip_smoke import card_line, check_metric, device_busy, \
        stacked_shards
    from rub_mimo_tpu_torch import ModemConfig
    from rub_mimo_tpu_torch.io import simulator
    from rub_mimo_tpu_torch.kernels import _build

    card = card_line()
    print(card, flush=True)
    OUT.mkdir(parents=True, exist_ok=True)
    jobs = {}
    for name in VARIANTS:
        cu = write_source(name, _build.CSRC)
        so = OUT / f"{name}.so"
        jobs[name] = (so, subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, "-I", str(_build.CSRC),
             "-o", str(so), str(cu)], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True))
    libs, ptxas = {}, {}
    for name, (so, proc) in jobs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise SystemExit(f"{name}: nvcc failed:\n{log[-4000:]}")
        ptxas[name] = [ln.strip() for ln in log.splitlines()
                       if "registers" in ln or "spill" in ln]
        lib = ctypes.CDLL(str(so))
        P, I = ctypes.c_void_p, ctypes.c_int
        lib.sc_metric.argtypes = [P, I, I, I, P, P]
        lib.sc_metric.restype = I
        lib.sc_metric_geometry.argtypes = [I, I, I, P]
        lib.sc_metric_geometry.restype = I
        libs[name] = lib

    def call(lib, x, M):
        S, T = x.shape
        out = torch.empty((S, T), dtype=torch.float32, device=x.device)
        err = lib.sc_metric(x.data_ptr(), S, T, M, out.data_ptr(),
                            torch.cuda.current_stream().cuda_stream)
        if err:
            raise SystemExit(f"sc_metric launch failed: CUDA error {err}")
        return out

    dev = torch.device("cuda")
    cfg = ModemConfig(pid_max=1000, bit_exact=False)
    cap = simulator.simulate_capture(cfg, simulator.ChannelSpec(
        snr_db=30.0, delay=5000, seed=42), device=dev)[0]
    stage_a = stacked_shards(cap, 4, cfg.M - 1)
    S = cap.shape[0]
    shapes = {"operating_point": cap, "sharded_stage_a": stage_a,
              "one_card_share": stage_a[S:2 * S].contiguous()}
    out = {"card": card, "calls": args.calls, "ptxas": ptxas,
           "tolerance_used": {}, "geometry": {}, "us": {}}
    for name, lib in libs.items():
        if VARIANTS[name][1]:
            out["tolerance_used"][name] = max(
                check_metric(x, cfg.M, cfg.plateau_threshold,
                             lambda x, M, lib=lib: call(lib, x, M))[
                    "tolerance_used"] for x in shapes.values())
    for name, lib in libs.items():
        geo = (ctypes.c_int * 6)()
        lib.sc_metric_geometry(*cap.shape, cfg.M, geo)
        out["geometry"][name] = dict(zip(
            ("grid", "blocks_per_sm", "sms", "threads", "chunk",
             "smem_bytes"), geo))
    order = list(libs) + list(libs)[::-1]
    for shape, x in shapes.items():
        out["us"][shape] = {}
        for name in order:
            busy = device_busy(lambda: call(libs[name], x, cfg.M),
                               n=args.calls)
            us = busy["busy_ms_median"]
            out["us"][shape].setdefault(name, []).append(
                None if us is None else us * 1e3)
    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
