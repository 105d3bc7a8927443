#!/usr/bin/env python3
"""Bring-up check of the PyTorch / CUDA port (rub_mimo_tpu_torch) on one
NVIDIA GPU.

    python3 chip_smoke.py

Builds the port's CUDA kernel from the sources in this checkout, holds it
against its plain PyTorch version, decodes the reference operating point
end to end through ``make_decoder(..., input_format="planes")``, decodes
the checked-in golden capture, times the decode and the kernel with CUDA
events, and breaks the decode down by stage (CUDA events per stage,
torch.profiler for the device's busy time).  Each phase prints one JSON
line; any failed check raises,
so the exit code is non-zero.  The last line is the device summary
{"ok": true, "device": {...}}.  There is no CPU path: without a CUDA
device the script exits non-zero before printing anything.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

REPO = Path(__file__).resolve().parent
GOLDEN = REPO / "tests" / "golden"
TIE_MARGIN = 1e-4    # decisions may differ only where the plain scores tie
SIG_REL_TOL = 1e-4   # max |kernel - plain| / RMS(plain) of rx_sig
TIMING_ITERS = 20


def require(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(msg)


def emit(obj: dict) -> None:
    print(json.dumps(obj), flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def top2_margin(y: torch.Tensor, table: np.ndarray) -> torch.Tensor:
    """The plain demap's best minus second-best score at each y."""
    from rub_mimo_tpu_torch.ofdm.constellation import demap_planes

    c = torch.as_tensor(demap_planes(table), device=y.device)
    scores = (y.real.unsqueeze(-1) * c[0] + y.imag.unsqueeze(-1) * c[1]
              - c[2])
    top = torch.topk(scores, 2, dim=-1).values
    return top[..., 0] - top[..., 1]


def compare(sig, data, ref_sig, ref_data, table) -> dict:
    """Kernel vs plain: decision mismatches (each must be a near-tie of
    the plain scores) and the rx_sig error relative to the plain RMS."""
    bad = data != ref_data
    n_bad = int(bad.sum())
    margins = top2_margin(ref_sig[bad], table).tolist() if n_bad else []
    out = {"mismatches": n_bad, "mismatch_margins": margins,
           "decisions": data.numel()}
    if sig is not None:
        err = (sig - ref_sig).abs()
        rms = float(torch.sqrt(torch.mean(ref_sig.abs() ** 2)))
        out.update(max_abs_err=float(err.max()),
                   rel_err=float(err.max()) / rms)
        require(out["rel_err"] <= SIG_REL_TOL,
                f"rx_sig error {out['rel_err']:.3e} > {SIG_REL_TOL} of RMS")
    require(all(m < TIE_MARGIN for m in margins),
            f"decision mismatches outside near-ties: margins {margins}")
    return out


def cuda_ms(fn, iters: int = TIMING_ITERS, warmup: int = 3) -> dict:
    """Median CUDA-event time of fn() (ms) over iters runs after warmup,
    plus the median host wall time of the same runs."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    dev_ms, wall_ms = [], []
    for _ in range(iters):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        t0 = time.perf_counter()
        a.record()
        fn()
        b.record()
        b.synchronize()
        wall_ms.append((time.perf_counter() - t0) * 1e3)
        dev_ms.append(a.elapsed_time(b))
    return {"median_ms": statistics.median(dev_ms),
            "min_ms": min(dev_ms), "max_ms": max(dev_ms),
            "wall_median_ms": statistics.median(wall_ms)}


def stage_times(cfg, re: torch.Tensor, im: torch.Tensor, sync_index: int
                ) -> dict:
    """Median CUDA-event ms of each stage of rx.decode, each called alone
    on the same capture, in the decode's order; the host syncs the decode
    makes inside a stage are part of that stage."""
    from rub_mimo_tpu_torch.detect import weights as weights_mod
    from rub_mimo_tpu_torch.estimate import ls
    from rub_mimo_tpu_torch.pipeline import rx
    from rub_mimo_tpu_torch.sync import matched_filter, schmidl_cox

    S, T, M, sym = cfg.num_streams, re.shape[-1], cfg.M, cfg.symbol_len
    iq = torch.complex(re, im)
    region = rx._extract_region(iq, sync_index, cfg)
    joint = (not cfg.bit_exact) and cfg.timing_mode == "joint"
    mf = matched_filter.search(region, cfg, joint=joint)
    G = ls.estimate_channel(region, mf.ac_index, cfg)

    def payload_extract():
        cstart = (min(max(sync_index, 0), T)
                  + int(mf.ac_index[S - 1, -1] + M) - sym)
        return [rx.extract_payload(p, cstart, cfg.pid_max * sym)
                for p in (re, im)]

    stages = {
        "complex_from_planes": lambda: torch.complex(re, im),
        "sync": lambda: int(schmidl_cox.synchronize(iq, cfg).sync_index),
        "region": lambda: rx._extract_region(iq, sync_index, cfg),
        "matched_filter": lambda: matched_filter.search(region, cfg,
                                                        joint=joint),
        "ls": lambda: ls.estimate_channel(region, mf.ac_index, cfg),
        "weights": lambda: weights_mod.weights_for(cfg, G),
        "payload_extract": payload_extract,
    }
    return {name: cuda_ms(fn)["median_ms"] for name, fn in stages.items()}


def device_busy(fn, n: int = 5) -> dict:
    """torch.profiler over n calls of fn: the card's busy ms per call (the
    union of its kernel and copy intervals) and kernels per call; busy is
    None when the profiler recorded no device activity."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    dev = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    busy_us, end = 0.0, float("-inf")
    for a, b in sorted((e.time_range.start, e.time_range.end) for e in dev):
        if b > end:
            busy_us += b - max(a, end)
            end = b
    kernels = [e for e in dev if "memcpy" not in e.name.lower()
               and "memset" not in e.name.lower()]
    return {"busy_ms": busy_us / n / 1e3 if dev else None,
            "kernels": len(kernels) / n,
            "top_kernels_us": sorted(
                ((e.name[:60], e.time_range.elapsed_us()) for e in kernels),
                key=lambda x: -x[1])[:5]}


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke.py: torch.cuda.is_available() is "
                         "false; this check runs only on a CUDA device")
    from rub_mimo_tpu_torch import ModemConfig, Modulation
    from rub_mimo_tpu_torch.detect import zf
    from rub_mimo_tpu_torch.io import simulator
    from rub_mimo_tpu_torch.kernels import _build
    from rub_mimo_tpu_torch.kernels import payload_fused as pf
    from rub_mimo_tpu_torch.ofdm import constellation
    from rub_mimo_tpu_torch.pipeline import report, rx

    dev = torch.device("cuda")
    card = card_line()
    print(card, flush=True)

    # ---- phase 1: device + kernel build ----
    t0 = time.perf_counter()
    pf._kernel_fn()
    build_s = time.perf_counter() - t0
    ptxas = Path(str(_build.library_path("payload_fused_strip")) + ".log")
    emit({"phase": "device", "card": card,
          "torch": torch.__version__, "cuda": torch.version.cuda,
          "name": torch.cuda.get_device_name(0),
          "kernel_build_s": build_s,
          "ptxas": [ln.strip() for ln in ptxas.read_text().splitlines()
                    if "registers" in ln or "spill" in ln]})

    # ---- phase 2: kernel vs plain on seeded random inputs ----
    table = constellation.table(Modulation.ARB32OPT)
    main_cmp = None
    for M, cp, n_sym in ((2048, 152, 1000), (2048, 152, 13), (64, 16, 8)):
        rng = np.random.default_rng(M + n_sym)
        S, sym = 2, M + cp
        p = torch.as_tensor(
            rng.standard_normal((2, S, n_sym * sym)).astype(np.float32),
            device=dev)
        G = ((rng.standard_normal((M, S, S))
              + 1j * rng.standard_normal((M, S, S))) / np.sqrt(2)
             + 2.0 * np.eye(S))  # diagonally dominant: well conditioned
        W, gain = zf.invert(torch.as_tensor(G.astype(np.complex64),
                                            device=dev))
        norm = np.float32(1.0 / np.sqrt(M))
        kw = dict(n_sym=n_sym, symbol_len=sym, cp_len=cp)
        sig, data = pf.payload_fused_strip(p[0], p[1], W, gain, table, norm,
                                           **kw)
        ref_sig, ref_data = pf.payload_tail_reference(
            p[0], p[1], W, gain, table, norm, **kw)
        torch.cuda.synchronize()
        res = compare(sig, data, ref_sig, ref_data, table)
        emit({"phase": "kernel_vs_plain", "M": M, "cp": cp, "n_sym": n_sym,
              **res})
        if main_cmp is None:
            main_cmp = res

    # ---- phase 3: the port's main path at the reference operating point
    cfg = ModemConfig(pid_max=1000, bit_exact=False)
    spec = simulator.ChannelSpec(snr_db=30.0, delay=5000, seed=42)
    cap, tx_data, _ = simulator.simulate_capture(cfg, spec, device=dev)
    re, im = cap.real.contiguous(), cap.imag.contiguous()
    del cap
    dec = rx.make_decoder(cfg, device=dev, input_format="planes")
    pf.payload_fused_strip.launches = 0
    r = dec(re, im)
    torch.cuda.synchronize()
    launches = pf.payload_fused_strip.launches
    require(launches == 1, f"K1 launched {launches} times in one decode")
    rep = report.score(r, tx_data, cfg)
    require(rep.synced, "operating-point capture did not sync")
    require(all(s == 0.0 for s in rep.symbol_error_rate),
            f"SER {rep.symbol_error_rate} at the operating point")
    S, T, M, sym = cfg.num_streams, re.shape[-1], cfg.M, cfg.symbol_len
    n_sym = cfg.pid_max
    cstart = min(max(int(r.sync_index), 0), T) + int(r.decode_start) - sym
    p_re = rx.extract_payload(re, cstart, n_sym * sym)
    p_im = rx.extract_payload(im, cstart, n_sym * sym)
    norm = np.float32(1.0 / np.sqrt(M))
    tab = constellation.table(cfg.modulation)
    kw = dict(n_sym=n_sym, symbol_len=sym, cp_len=cfg.cp_len)
    ref_sig, ref_data = pf.payload_tail_reference(
        p_re, p_im, r.W, r.normalize_gain, tab, norm, **kw)
    e2e = compare(r.rx_sig.reshape(S, n_sym, M), r.rx_data.reshape(
        S, n_sym, M), ref_sig, ref_data, tab)
    emit({"phase": "end_to_end", "capture": [S, T], "synced": rep.synced,
          "sync_index": rep.sync_index, "ser_percent": rep.symbol_error_rate,
          "evm_percent": rep.evm_percent, "k1_launches_per_decode": launches,
          **e2e})

    # ---- phase 4: golden capture (M=64) ----
    manifest = json.loads((GOLDEN / "manifest.json").read_text())
    gcfg = ModemConfig.from_json(json.dumps(manifest["config"]))
    chans = [np.fromfile(GOLDEN / f"rx{s + 1}.dat", dtype=np.complex64)
             for s in range(gcfg.num_streams)]
    n = min(len(c) for c in chans)
    gcap = np.stack([c[:n] for c in chans])
    before = pf.payload_fused_strip.launches
    g = rx.make_decoder(gcfg, device=dev)(gcap)
    torch.cuda.synchronize()
    exp_data = np.load(GOLDEN / "expected_rx_data.npy")
    exp_G = np.load(GOLDEN / "expected_G.npy")
    got_data = g.rx_data.cpu().numpy()
    require(np.array_equal(got_data, exp_data),
            f"golden rx_data: {int((got_data != exp_data).sum())} mismatches")
    np.testing.assert_allclose(g.G.cpu().numpy(), exp_G, rtol=1e-4, atol=1e-6)
    emit({"phase": "golden", "rx_data_equal": True, "G_rtol": 1e-4,
          "k1_launches": pf.payload_fused_strip.launches - before})

    # ---- phase 5: times (CUDA events, medians over TIMING_ITERS) ----
    t_dec = cuda_ms(lambda: dec(re, im))
    t_k1 = cuda_ms(lambda: pf.payload_fused_strip(
        p_re, p_im, r.W, r.normalize_gain, tab, norm, **kw))
    t_plain = cuda_ms(lambda: pf.payload_tail_reference(
        p_re, p_im, r.W, r.normalize_gain, tab, norm, **kw))
    emit({"phase": "times", "card": card, "iters": TIMING_ITERS,
          "decode": t_dec, "k1": t_k1, "plain_tail": t_plain,
          "decode_samples_per_s": S * T / (t_dec["median_ms"] * 1e-3)})

    # ---- phase 6: where the decode's time goes ----
    busy = device_busy(lambda: dec(re, im))
    emit({"phase": "stages", "card": card, "iters": TIMING_ITERS,
          "stage_ms": stage_times(cfg, re, im, int(r.sync_index)),
          "k1_ms": t_k1["median_ms"], "decode_ms": t_dec["median_ms"],
          "profiled_decodes": 5,
          "device_busy_ms_per_decode": busy["busy_ms"],
          "device_idle_share": (None if busy["busy_ms"] is None else
                                1.0 - busy["busy_ms"] / t_dec["median_ms"]),
          "device_kernels_per_decode": busy["kernels"],
          "longest_kernels_us": busy["top_kernels_us"]})

    emit({"kernels": [{
        "name": "payload_fused_strip",
        "route": "cuda",
        "source": "rub_mimo_tpu_torch/kernels/csrc/payload_fused_strip.cu",
        "replaces": "rub_mimo_tpu/kernels/payload_fused.py:548",
        "launches": launches,
        "max_abs_err": main_cmp["max_abs_err"],
        "ms": t_k1["median_ms"],
        "plain_ms": t_plain["median_ms"],
    }]})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})


if __name__ == "__main__":
    main()
    sys.exit(0)
