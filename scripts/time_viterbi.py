#!/usr/bin/env python3
"""The coded back end's two device-bound stages on one NVIDIA GPU: the
Viterbi kernel (rub_mimo_tpu_torch/kernels/csrc/viterbi.cu) and the max-log
LLRs (``constellation.soft_demodulate_llr``).

    python3 scripts/time_viterbi.py [--root DIR] [--calls 10]

Inputs are seeded at the reference operating point's shapes
(``ModemConfig(pid_max=1000, bit_exact=False)`` at rate 1/2): the Viterbi's
2,500 windows of 4,352 steps ([2500, 4352, 2] float32 LLR pairs from a
normal distribution, uniform prior: the kernel's work does not depend on
the values) and the LLRs of [2, 2,048,000] ARB32OPT symbols at noise_var
1.0.  ``--root`` imports rub_mimo_tpu_torch from DIR instead of this
checkout, so that two versions (an unpacked parent commit and this one)
are timed in one run on one card; the timer is this checkout's
``chip_smoke.device_busy`` either way.  Prints the card line, then one
JSON line: per stage the device busy time per call (median over
``--calls`` profiled calls), the CUDA-event median and a SHA-256 of the
output (equal digests: the same bits from both versions).  Exits
non-zero without a CUDA device."""

from __future__ import annotations

import argparse
import hashlib
import json
import sys
from pathlib import Path

import numpy as np
import torch

REPO = Path(__file__).resolve().parents[1]


def digest(t: torch.Tensor) -> str:
    return hashlib.sha256(t.cpu().numpy().tobytes()).hexdigest()[:16]


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=str(REPO))
    ap.add_argument("--calls", type=int, default=10)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("time_viterbi.py: no CUDA device")
    sys.path.insert(0, str(REPO))
    from chip_smoke import card_line, cuda_ms, device_busy

    sys.path.insert(0, str(Path(args.root).resolve()))
    from rub_mimo_tpu_torch import Modulation
    from rub_mimo_tpu_torch.kernels import viterbi as kv
    from rub_mimo_tpu_torch.ofdm import constellation

    dev = torch.device("cuda")
    card = card_line()
    print(card, flush=True)
    rng = np.random.default_rng(4352)
    pairs = torch.as_tensor(
        (rng.standard_normal((2500, 4352, 2)) * 2.0).astype(np.float32),
        device=dev)
    pinned = torch.zeros(2500, dtype=torch.bool, device=dev)

    def call():
        return kv.viterbi(pairs, pinned)

    busy = device_busy(call, n=args.calls)
    out = {"card": card, "root": str(Path(args.root).resolve()),
           "calls": args.calls,
           "viterbi": {"busy_ms_median": busy["busy_ms_median"],
                       "busy_ms": busy["busy_ms"],
                       "event_ms": cuda_ms(call, iters=args.calls)[
                           "median_ms"],
                       "bits_sha256": digest(call())}}
    y = torch.as_tensor(
        ((rng.standard_normal((2, 2_048_000))
          + 1j * rng.standard_normal((2, 2_048_000))) * 0.7
         ).astype(np.complex64), device=dev)

    def llr():
        return constellation.soft_demodulate_llr(y, Modulation.ARB32OPT, 1.0)

    busy = device_busy(llr, n=args.calls)
    out["soft_demodulate_llr"] = {
        "busy_ms_median": busy["busy_ms_median"], "busy_ms": busy["busy_ms"],
        "event_ms": cuda_ms(llr, iters=args.calls)["median_ms"],
        "llrs_sha256": digest(llr())}
    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
