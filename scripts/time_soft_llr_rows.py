#!/usr/bin/env python3
"""The coded back end's front half on one NVIDIA GPU: the soft-LLR rows
kernel (rub_mimo_tpu_torch/kernels/csrc/soft_llr.cu, ``soft_llr_rows``)
against the three stages it replaces, and the whole back end.

    python3 scripts/time_soft_llr_rows.py [--root DIR] [--calls 10] [--ablate]

Inputs are seeded at the reference operating point's shapes
(``ModemConfig(pid_max=1000, bit_exact=False)``): [2, 2,048,000] ARB32OPT
symbols at noise_var 1.0.  For the package at ``--root`` (default this
checkout; an unpacked parent commit times the parent in the same run on
the same card) it times, at rate 1/2, the three stages of the old front
half as that package runs them: the LLRs
(``constellation.soft_demodulate_llr``), the deinterleave and depuncture
gathers, and ``fec.viterbi_rows``' pad and window copies; where the
package has it, the rows kernel at rates 1/2, 2/3 and 3/4; and
``fec.decode_payload`` (the whole back end) at the three rates.  Each time
is the device busy time per call from torch.profiler (median over
``--calls`` profiled calls; this checkout's ``chip_smoke.device_busy``),
with the CUDA-event median beside it and a SHA-256 of the rows (equal
digests: the same values from the old stages and the kernel).
``--ablate`` (this checkout only) builds copies of csrc/soft_llr.cu into
rub_mimo_tpu_torch/_build/ (``VARIANTS``): the fast path with ``hypotf``
a point in place of the square-root form, every symbol through the rare
path, at most 48 registers a thread (five blocks an SM), and no
distances at all (the index plan and the stores alone), and times each
on the rate-1/2 rows: what ``hypotf``, the rare path, occupancy and the
stores cost.  The last variant's values differ from the kernel's; they
are timed only.
Prints the card line, then one JSON line.  Exits non-zero without a
CUDA device."""

from __future__ import annotations

import argparse
import ctypes
import hashlib
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

REPO = Path(__file__).resolve().parents[1]
RATES = ("1/2", "2/3", "3/4")
# name -> (text of csrc/soft_llr.cu, its replacement), applied in order
VARIANTS = {
    # the fast path with hypotf a point (d itself, the half minima of d):
    # the arithmetic before the square-root form
    "hypotf": [
        ("      const float big = fmaxf(dx, dy), small = fminf(dx, dy);\n"
         "      float e = __fmaf_rn(big, big, __fmul_rn(small, small));",
         "      float e = dist(v, pts.c[k]); (void)dx; (void)dy;"),
        ("    const float dn = __fsqrt_rn(near);",
         "    const float dn = near;"),
        ("      const float d = __fsqrt_rn(zero_near ? hi[b] : lo[b]);",
         "      const float d = zero_near ? hi[b] : lo[b];")],
    # every symbol through the rare path (hypotf and a scaling a point, a
    # loop)
    "rare_path_only": [
        ("  if (pts.fast && nv > 0.0f",
         "  if (false && pts.fast && nv > 0.0f")],
    # at most 48 registers a thread: five blocks an SM in place of four
    "five_blocks_an_sm": [
        ("__global__ void __launch_bounds__(kThreads)\nsoft_llr_rows_kernel(",
         "__global__ void __launch_bounds__(kThreads, 5)\n"
         "soft_llr_rows_kernel(")],
    # no distances: each symbol's LLRs are its own index (the index plan
    # and the stores alone)
    "no_distances": [
        ("        symbol_llrs<BITS>(static_cast<const float2*>(x)[e], "
         "pts, pts_dev,\n                          nv, inv, reciprocal "
         "!= 0, llr);",
         "        for (int b = 0; b < BITS; ++b) llr[b] = (float)(e + b);")],
}


def digest(t: torch.Tensor) -> str:
    return hashlib.sha256(t.cpu().numpy().tobytes()).hexdigest()[:16]


def timed(busy_fn, event_fn, fn, calls: int) -> dict:
    busy = busy_fn(fn, n=calls)
    return {"busy_ms_median": busy["busy_ms_median"],
            "busy_ms": busy["busy_ms"], "kernels": busy["kernels"],
            "event_ms": event_fn(fn, iters=calls)["median_ms"]}


def ablation(y, tab, plan, busy_fn, calls: int) -> dict:
    """The rows kernel with its distance replaced, and with no distances:
    device busy ms a call of each copy, built beside the real one."""
    from rub_mimo_tpu_torch.kernels import _build
    from rub_mimo_tpu_torch.kernels import soft_llr as ks

    src = (REPO / "rub_mimo_tpu_torch/kernels/csrc/soft_llr.cu").read_text()
    sources = {}
    for name, edits in VARIANTS.items():
        text = src
        for old, new in edits:
            if text.count(old) != 1:
                raise SystemExit(f"time_soft_llr_rows.py: {name}: the "
                                 "kernel's source no longer has the text "
                                 "the ablation replaces")
            text = text.replace(old, new)
        sources[name] = text
    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    L, N = y.shape
    bits = int(len(tab)).bit_length() - 1
    g = ks.row_geometry(plan, N * bits, N)
    out = torch.empty((L * g.rows, g.out_len // 2, 2), dtype=torch.float32,
                      device=y.device)
    res = {}
    for name, text in sources.items():
        cu = _build.BUILD_DIR / f"soft_llr_{name}.cu"
        lib_path = _build.BUILD_DIR / f"soft_llr_{name}.so"
        cu.write_text(text)
        subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-o",
                        str(lib_path), str(cu)], check=True,
                       capture_output=True)
        fn = ctypes.CDLL(str(lib_path)).soft_llr_rows
        P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        fn.argtypes = [P, I, I, P, P, I, F, P, I, P, F, P, P]
        fn.restype = I
        pts = np.ascontiguousarray(tab, np.complex64)
        pts_dev = torch.as_tensor(pts.copy(), device=y.device)
        geom = (ctypes.c_longlong * len(g))(*g)

        def call(fn=fn, pts=pts, pts_dev=pts_dev, geom=geom):
            err = fn(y.data_ptr(), 0, L, pts.ctypes.data,
                     pts_dev.data_ptr(), bits, 1.0, None, 1, geom, 1e4,
                     out.data_ptr(), torch.cuda.current_stream().cuda_stream)
            if err != 0:
                raise SystemExit(f"time_soft_llr_rows.py: {name} launch "
                                 f"failed: CUDA error {err}")

        busy = busy_fn(call, n=calls)
        res[name] = {"busy_ms_median": busy["busy_ms_median"],
                     "busy_ms": busy["busy_ms"]}
    return res


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=str(REPO))
    ap.add_argument("--calls", type=int, default=10)
    ap.add_argument("--ablate", action="store_true")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("time_soft_llr_rows.py: no CUDA device")
    root = Path(args.root).resolve()
    if args.ablate and root != REPO:
        raise SystemExit("time_soft_llr_rows.py: --ablate times this "
                         "checkout's kernel only")
    sys.path.insert(0, str(REPO))
    from chip_smoke import card_line, cuda_ms, device_busy

    sys.path.insert(0, str(root))
    from rub_mimo_tpu_torch import ModemConfig
    from rub_mimo_tpu_torch.kernels import soft_llr as ks
    from rub_mimo_tpu_torch.ofdm import constellation, fec

    dev = torch.device("cuda")
    card = card_line()
    print(card, flush=True)
    cfg = ModemConfig(pid_max=1000, bit_exact=False)
    N = cfg.pid_max * cfg.M_occupied
    rng = np.random.default_rng(2_048_000)
    y = torch.as_tensor(
        ((rng.standard_normal((2, N)) + 1j * rng.standard_normal((2, N)))
         * 0.7).astype(np.complex64), device=dev)
    tab = constellation.table(cfg.modulation)
    out = {"card": card, "root": str(root), "calls": args.calls,
           "symbols": list(y.shape)}

    def run(fn):
        return timed(device_busy, cuda_ms, fn, args.calls)

    # the old front half's three stages at rate 1/2, as this package runs
    # them
    n_msg = fec.message_bits_per_stream(cfg)
    used = 2 * (n_msg + fec.TAIL)
    lv = constellation.soft_demodulate_llr(y, cfg.modulation, 1.0).reshape(
        2, -1)

    def deinterleave_depuncture():
        x = fec.deinterleave(lv, fec.INTERLEAVE_SPREAD)
        return fec.depuncture_llrs(x[:, :fec._kept_bits(used, "1/2")],
                                   used, "1/2")

    dep = deinterleave_depuncture()
    old = {
        "llr": run(lambda: constellation.soft_demodulate_llr(
            y, cfg.modulation, 1.0)),
        "deinterleave_depuncture": run(deinterleave_depuncture),
        "viterbi_rows": run(lambda: fec.viterbi_rows(dep, 4096)),
    }
    old["sum_busy_ms"] = sum(v["busy_ms_median"] or v["busy_ms"]
                             for v in old.values())
    old["rows_sha256"] = digest(fec.viterbi_rows(dep, 4096)[0])
    old["llrs_sha256"] = digest(lv)
    out["old_stages_rate_1/2"] = old
    if hasattr(ks, "soft_llr_rows"):
        rows = {}
        for rate in RATES:
            plan = fec.row_plan(N * cfg.modulation.bits_per_symbol, cfg,
                                rate)
            rows[rate] = {**run(lambda plan=plan: ks.soft_llr_rows(
                y, plan, tab, 1.0)), "rows_sha256": digest(
                ks.soft_llr_rows(y, plan, tab, 1.0)[0])}
        out["soft_llr_rows"] = rows
    out["back_end"] = {rate: run(lambda rate=rate: fec.decode_payload(
        y, cfg, 1.0, rate=rate)) for rate in RATES}
    if args.ablate:
        out["ablation_rate_1/2"] = ablation(
            y, tab, fec.row_plan(N * cfg.modulation.bits_per_symbol, cfg),
            device_busy, args.calls)
    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
