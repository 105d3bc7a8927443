#!/usr/bin/env python3
"""K6 (the S&C metric, rub_mimo_tpu_torch/kernels/csrc/sc_metric.cu) and
the full-rate plateau scan on one NVIDIA GPU.

    python3 scripts/time_k6.py [--root DIR] [--calls 10]

Runs torch.profiler over ``--calls`` calls of ``sc_metric_fused`` at the
three shapes its paths give it, all from the reference operating point's
capture (``ModemConfig(pid_max=1000, bit_exact=False)``,
``ChannelSpec(snr_db=30, delay=5000, seed=42)``, M = 2048):

- ``operating_point``: the [2, 2,297,248] capture (``keep_debug``, the
  full-rate scan);
- ``sharded_stage_a``: the stacked rows of the (4, 1) sharded full-rate
  stage A on one card, [8, M - 1 + Tloc] (each shard's left halo, then
  its samples);
- ``one_card_share``: one card's rows of that stage across four cards,
  [2, M - 1 + Tloc].

Each is held against ``sc_metric_reference`` first by
``chip_smoke.check_metric`` (NaN exactly on the windows of zeros, rtol
2e-3 and atol 1e-4 on samples with real energy, flips only near the
threshold).
Then the plateau scan of the full-rate sync on the operating point's
metric, with one ``torch.cummax`` per row (one thread block each) and
with ``sc_sync.plateau_scan`` as it stands.  ``--root`` imports
rub_mimo_tpu_torch from DIR instead of this checkout, so that two
versions (an unpacked parent commit and this one) are timed in one run
on one card; the timer is this checkout's
``chip_smoke.device_busy`` either way.  Prints the card line, then one
JSON line: per shape the device busy time per call (mean and median over
the calls), each kernel's median µs per launch, the bytes bound and its
share, and the kernel's grid where the wrapper reports it; the
compiler's report (``-Xptxas -v``) of the library; the plateau scans'
times.  Exits non-zero without a CUDA device or on a mismatch."""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

import torch

REPO = Path(__file__).resolve().parents[1]


def plateau_scan_one_block(metric: torch.Tensor, cp_len: int,
                           threshold: float):
    """The plateau scan with one torch.cummax over each [T] row, as it
    was before the two-level scan (a yardstick here only)."""
    S, T = metric.shape
    above = metric > threshold
    idx = torch.arange(T, device=metric.device).expand(S, T)
    last_below = torch.cummax(
        torch.where(above, torch.full_like(idx, -1), idx), dim=1).values
    run_start = last_below + 1
    cond = above & ((idx - run_start) > cp_len)
    fire = cond.sum(dim=0) >= S
    t_star = torch.argmax(fire.to(torch.uint8))
    return fire[t_star], t_star, run_start[:, t_star], cond[:, t_star]


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=str(REPO))
    ap.add_argument("--calls", type=int, default=10)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("time_k6.py: no CUDA device")
    sys.path.insert(0, str(REPO))
    from chip_smoke import (HBM_BYTES_PER_S, card_line, check_metric,
                            device_busy, stacked_shards)

    sys.path.insert(0, str(Path(args.root).resolve()))
    from rub_mimo_tpu_torch import ModemConfig
    from rub_mimo_tpu_torch.io import simulator
    from rub_mimo_tpu_torch.kernels import _build
    from rub_mimo_tpu_torch.kernels import sc_metric as k6
    from rub_mimo_tpu_torch.kernels import sc_sync as k5

    card = card_line()
    print(card, flush=True)
    dev = torch.device("cuda")
    cfg = ModemConfig(pid_max=1000, bit_exact=False)
    spec = simulator.ChannelSpec(snr_db=30.0, delay=5000, seed=42)
    cap = simulator.simulate_capture(cfg, spec, device=dev)[0]
    M = cfg.M
    stacked = stacked_shards(cap, 4, M - 1)
    S = cap.shape[0]
    shapes = {"operating_point": cap, "sharded_stage_a": stacked,
              "one_card_share": stacked[S:2 * S].contiguous()}
    lib = _build.build("sc_metric")
    out = {"card": card, "root": str(Path(args.root).resolve()),
           "calls": args.calls, "M": M, "shapes": {},
           "ptxas": [ln.strip() for ln in
                     Path(str(lib) + ".log").read_text().splitlines()
                     if "registers" in ln or "spill" in ln
                     or "Compiling" in ln]}
    for name, x in shapes.items():
        cmp = check_metric(x, M, cfg.plateau_threshold)
        busy = device_busy(lambda x=x: k6.sc_metric_fused(x, M),
                           n=args.calls)
        if busy["busy_ms"] is None:
            raise SystemExit(f"{name}: the profiler recorded no device "
                             "activity")
        n_bytes = x.numel() * (x.element_size() + 4)
        res = {"shape": list(x.shape), "busy_us": busy["busy_ms"] * 1e3,
               "busy_us_median": (None if busy["busy_ms_median"] is None
                                  else busy["busy_ms_median"] * 1e3),
               "kernels_us": busy["kernels_us"],
               "bound_us": n_bytes / HBM_BYTES_PER_S * 1e6,
               "tolerance_used": cmp["tolerance_used"],
               "max_abs_err": cmp["max_abs_err"]}
        res["bound_share"] = res["bound_us"] / res["busy_us"]
        if hasattr(k6, "metric_geometry"):
            res["geometry"] = k6.metric_geometry(*x.shape, M)
        out["shapes"][name] = res
    # the full-rate sync's plateau scan on the operating point's metric:
    # one torch.cummax per row against plateau_scan as it stands, in turns
    metric = k6.sc_metric_fused(cap, M)
    scan_args = (metric, cfg.cp_len, cfg.plateau_threshold)
    old, new = plateau_scan_one_block(*scan_args), k5.plateau_scan(
        *scan_args)
    torch.cuda.synchronize()
    if not all(torch.equal(a, b) for a, b in zip(old, new)):
        raise SystemExit("plateau_scan differs from the one-block scan")
    out["plateau_scan"] = {"t_star": int(new[1])}
    for name, fn in (("one_block_cummax",
                      lambda: plateau_scan_one_block(*scan_args)),
                     ("plateau_scan", lambda: k5.plateau_scan(*scan_args)),
                     ("one_block_cummax_again",
                      lambda: plateau_scan_one_block(*scan_args))):
        busy = device_busy(fn, n=args.calls)
        out["plateau_scan"][name] = {
            "busy_us": None if busy["busy_ms"] is None
            else busy["busy_ms"] * 1e3,
            "kernels": busy["kernels"],
            "top_kernels_us": busy["top_kernels_us"][:3]}
    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
