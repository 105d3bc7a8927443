#!/usr/bin/env python3
"""K5 (the one-pass sync, rub_mimo_tpu_torch/kernels/csrc/sc_sync.cu) on
one NVIDIA GPU, kernel by kernel.

    python3 scripts/time_k5.py [--root DIR] [--calls 10]

Runs torch.profiler over ``--calls`` calls of ``sc_sync_fused`` on two
[2, 2,297,248] captures: the reference operating point
(``ModemConfig(pid_max=1000, bit_exact=False)``, ``ChannelSpec(snr_db=30,
delay=5000, seed=42)``, which fires at t* = 7,147) and seeded complex
Gaussian noise of the same shape, which never fires.  ``--root`` imports
rub_mimo_tpu_torch from DIR instead of this checkout, so that two
versions (an unpacked parent commit and this one) are timed in one run on
one card; the timer is this checkout's ``chip_smoke.device_busy``
either way.  Prints the card line, then one JSON line: per capture, the
device busy time per call (the union of its kernels and memsets: the
mean and the median over the calls), each kernel's median µs per launch,
the bytes bound (the samples up to t* when it fires, the whole capture
when not) and its share, and the chunks scanned where the kernel reports
them.  Exits non-zero without a CUDA device."""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

import numpy as np
import torch

REPO = Path(__file__).resolve().parents[1]


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=str(REPO))
    ap.add_argument("--calls", type=int, default=10)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("time_k5.py: no CUDA device")
    sys.path.insert(0, str(REPO))
    from chip_smoke import HBM_BYTES_PER_S, card_line, device_busy

    sys.path.insert(0, str(Path(args.root).resolve()))
    from rub_mimo_tpu_torch import ModemConfig
    from rub_mimo_tpu_torch.io import simulator
    from rub_mimo_tpu_torch.kernels import sc_sync as k5

    card = card_line()
    print(card, flush=True)
    dev = torch.device("cuda")
    cfg = ModemConfig(pid_max=1000, bit_exact=False)
    spec = simulator.ChannelSpec(snr_db=30.0, delay=5000, seed=42)
    cap = simulator.simulate_capture(cfg, spec, device=dev)[0]
    S, T = cap.shape
    rng = np.random.default_rng(8)
    noise = torch.as_tensor((rng.standard_normal((S, T))
                             + 1j * rng.standard_normal((S, T)))
                            .astype(np.complex64), device=dev)
    out = {"card": card, "root": str(Path(args.root).resolve()),
           "calls": args.calls, "capture": [S, T], "captures": {}}
    for name, x in (("operating_point", cap), ("no_fire", noise)):
        sync_args = (x, cfg.M, cfg.cp_len, cfg.plateau_threshold)
        synced, t_star, _, _ = k5.sc_sync_fused(*sync_args)
        ref = k5.sc_sync_reference(*sync_args)
        torch.cuda.synchronize()
        fired, t = bool(synced), int(t_star)
        if (fired, t) != (bool(ref[0]), int(ref[1])):
            raise SystemExit(f"{name}: kernel (synced, t*) = {(fired, t)}, "
                             f"plain {(bool(ref[0]), int(ref[1]))}")
        busy = device_busy(lambda: k5.sc_sync_fused(*sync_args),
                           n=args.calls)
        if busy["busy_ms"] is None:
            raise SystemExit(f"{name}: the profiler recorded no device "
                             "activity")
        res = {"synced": fired, "t_star": t, "busy_us": busy["busy_ms"] * 1e3,
               "busy_us_median": (None if busy["busy_ms_median"] is None
                                  else busy["busy_ms_median"] * 1e3),
               "kernels_us": busy["kernels_us"]}
        scanned = getattr(k5.sc_sync_fused, "chunks_scanned", None)
        if scanned is not None:
            res.update(chunks=k5.sc_sync_fused.chunks,
                       chunks_scanned=int(scanned))
        n_bytes = S * ((t + 1) if fired else T) * x.element_size()
        res["bound_us"] = n_bytes / HBM_BYTES_PER_S * 1e6
        res["bound_share"] = res["bound_us"] / res["busy_us"]
        out["captures"][name] = res
    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
