#!/usr/bin/env python3
"""Bring-up check of the PyTorch / CUDA port (rub_mimo_tpu_torch) on one
NVIDIA GPU.

    python3 chip_smoke.py

Builds the port's CUDA kernels from the sources in this checkout (K1 the
payload tail, K5 the one-pass sync, K6 the S&C metric; one nvcc each, all
at once) and holds each against its plain PyTorch version: K1 on seeded
random payloads, K6 on a seeded random capture and the operating-point
capture, K5 on six captures (the operating point, the earliest fire at
full width and at M=64, a fire in the last tile, noise only, 10^5 leading
zeros).  Then it decodes the reference operating point end to end through
``make_decoder(..., input_format="planes")`` on each path this port
offers: the default coarse sync, ``sync_impl="pallas"`` (K5),
``keep_debug=True`` (K6), and the CFO config (correct_cfo, sync_fallback,
smooth_channel) on a capture with a CFO.  Every launch count is set to 0
just before a path runs and read just after.  It decodes the checked-in
golden capture, times the decodes and the kernels with CUDA events, and
breaks the decode down by stage (CUDA events per stage, torch.profiler
for the device's busy time).  Each phase prints one JSON line; any failed
check raises, so the exit code is non-zero.  The last line is the device
summary {"ok": true, "device": {...}}.  There is no CPU path: without a
CUDA device the script exits non-zero before printing anything.
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
# K6 against its plain version: the tolerance of the JAX package's metric
# kernel test (chunked cumsum rounding), on finite samples whose plain
# energy is not a cancellation residue (>= ENERGY_FLOOR of the median)
METRIC_RTOL, METRIC_ATOL, ENERGY_FLOOR = 2e-3, 1e-4, 1e-6
FLIP_BAND = 1e-5     # an above-threshold flip lies this close to 0.95
CFO_TOL = 1e-4       # |delta cfo| of K5's corr at t* (a direct sum)
INT_FIELDS = ("synced", "sync_index", "sync_sample", "plateau_start",
              "plateau_end", "s0_index", "ac_index", "decode_start",
              "rx_data", "symbol_valid")


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
        "sync_pallas": lambda: int(schmidl_cox.synchronize(
            iq, cfg, impl="pallas").sync_index),
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


def launch_counts() -> dict:
    """The launch-counted wrappers of the port's kernels, by kernel."""
    from rub_mimo_tpu_torch.kernels import payload_fused as pf
    from rub_mimo_tpu_torch.kernels import sc_metric as k6
    from rub_mimo_tpu_torch.kernels import sc_sync as k5

    return {"payload_fused_strip": pf.payload_fused_strip,
            "sc_sync": k5.sc_sync_fused, "sc_metric": k6.sc_metric_fused}


def drive(fn):
    """Run fn() once with every launch count set to 0 just before; return
    its result and the counts read just after."""
    wrappers = launch_counts()
    for w in wrappers.values():
        w.launches = 0
    out = fn()
    torch.cuda.synchronize()
    return out, {name: w.launches for name, w in wrappers.items()}


def check_metric(x: torch.Tensor, M: int, thr: float) -> dict:
    """K6 against its plain version on capture x: the tolerance on finite
    samples with real energy, and every above-threshold flip within
    FLIP_BAND of the threshold."""
    from rub_mimo_tpu_torch.kernels import sc_metric as k6

    got = k6.sc_metric_fused(x, M)
    ref = k6.sc_metric_reference(x, M)
    _, energy = k6.moving_corr_energy(x, M)
    torch.cuda.synchronize()
    require(got.dtype == torch.float32 and got.shape == ref.shape,
            f"K6 output {got.dtype} {tuple(got.shape)}")
    ok = torch.isfinite(ref) & (energy >= ENERGY_FLOOR * energy.median())
    g, r = got[ok], ref[ok]
    err = (g - r).abs()
    use = err / (METRIC_ATOL + METRIC_RTOL * r.abs())
    big = r.abs() >= METRIC_ATOL
    flips = ((got > thr) != (ref > thr))
    flip_dist = (ref[flips] - thr).abs()
    out = {"T": x.shape[-1], "M": M, "checked": int(ok.sum()),
           "max_abs_err": float(err.max()),
           "max_rel_err": float((err[big] / r[big].abs()).max()),
           "tolerance_used": float(use.max()),
           "above_flips": int(flips.sum()),
           "max_flip_distance": float(flip_dist.max()) if flip_dist.numel()
           else 0.0}
    require(bool(torch.isfinite(g).all()) and out["tolerance_used"] <= 1.0,
            f"K6 outside rtol {METRIC_RTOL} atol {METRIC_ATOL}: {out}")
    require(out["max_flip_distance"] < FLIP_BAND,
            f"K6 flips a decision away from the threshold: {out}")
    return out


def check_sync(name: str, x: torch.Tensor, cfg) -> dict:
    """K5 against its plain version on capture x: synced, t* and the run
    starts equal, the CFO of corr at t* within CFO_TOL."""
    from rub_mimo_tpu_torch.kernels import sc_metric as k6
    from rub_mimo_tpu_torch.kernels import sc_sync as k5

    args = (x, cfg.M, cfg.cp_len, cfg.plateau_threshold)
    got = k5.sc_sync_fused(*args)
    ref = k5.sc_sync_reference(*args)
    torch.cuda.synchronize()
    cfo = [float(torch.angle((-c).sum()) / np.pi) for c in (got[3], ref[3])]
    tile = k5._kernel().sc_sync_tile_len(cfg.M)
    t_star = int(ref[1])
    out = {"case": name, "T": x.shape[-1], "M": cfg.M,
           "synced": bool(ref[0]), "t_star": t_star,
           "tile": t_star // tile, "last_tile": (x.shape[-1] - 1) // tile,
           "starts": ref[2].tolist(), "kernel_t_star": int(got[1]),
           "kernel_starts": got[2].tolist(), "dcfo": abs(cfo[0] - cfo[1]),
           "corr_abs_err": float((got[3] - ref[3]).abs().max())}
    same = (bool(got[0]) == bool(ref[0]) and int(got[1]) == t_star
            and torch.equal(got[2], ref[2]))
    if not same:
        # where the decisions part: the plain metric's distance to the
        # threshold at the first position whose above bit differs
        thr = cfg.plateau_threshold
        m_ref = k6.sc_metric_reference(x, cfg.M)
        diff = ((k6.sc_metric_fused(x, cfg.M) > thr) != (m_ref > thr))
        pos = torch.nonzero(diff)
        if pos.numel():
            s, t = pos[torch.argmin(pos[:, 1])].tolist()
            out["first_differing"] = [s, t, float(m_ref[s, t] - thr)]
    emit({"phase": "k5_vs_plain", **out})
    require(same, f"K5 integers differ from the plain version: {name}")
    require(out["dcfo"] < CFO_TOL, f"K5 cfo differs by {out['dcfo']}")
    return out


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke.py: torch.cuda.is_available() is "
                         "false; this check runs only on a CUDA device")
    from rub_mimo_tpu_torch import ModemConfig, Modulation, tiny_config
    from rub_mimo_tpu_torch.detect import zf
    from rub_mimo_tpu_torch.io import simulator
    from rub_mimo_tpu_torch.kernels import _build
    from rub_mimo_tpu_torch.kernels import payload_fused as pf
    from rub_mimo_tpu_torch.kernels import sc_metric as k6
    from rub_mimo_tpu_torch.kernels import sc_sync as k5
    from rub_mimo_tpu_torch.ofdm import constellation
    from rub_mimo_tpu_torch.pipeline import report, rx

    dev = torch.device("cuda")
    card = card_line()
    print(card, flush=True)

    # ---- phase 1: device + kernel builds (one nvcc per source, at once)
    sources = list(launch_counts())
    t0 = time.perf_counter()
    libs = _build.build_all(sources)
    pf._kernel_fn()
    k5._kernel()
    k6._kernel_fn()
    build_s = time.perf_counter() - t0
    emit({"phase": "device", "card": card,
          "torch": torch.__version__, "cuda": torch.version.cuda,
          "name": torch.cuda.get_device_name(0),
          "kernel_build_s": build_s,
          "ptxas": {name: [ln.strip() for ln in
                           Path(str(lib) + ".log").read_text().splitlines()
                           if "registers" in ln or "spill" in ln]
                    for name, lib in zip(sources, libs)}})

    # ---- phase 2: K1 vs plain on seeded random inputs ----
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

    # ---- the reference operating point's capture ----
    cfg = ModemConfig(pid_max=1000, bit_exact=False)
    spec = simulator.ChannelSpec(snr_db=30.0, delay=5000, seed=42)
    cap, tx_data, _ = simulator.simulate_capture(cfg, spec, device=dev)
    re, im = cap.real.contiguous(), cap.imag.contiguous()
    thr = cfg.plateau_threshold

    # ---- phase 3: K6 vs plain (seeded random, operating point) ----
    rng = np.random.default_rng(20)
    noise = torch.as_tensor(
        (rng.standard_normal((2, (1 << 20) + 777))
         + 1j * rng.standard_normal((2, (1 << 20) + 777)))
        .astype(np.complex64), device=dev)
    emit({"phase": "k6_vs_plain", "case": "random",
          **check_metric(noise, cfg.M, thr)})
    k6_cmp = check_metric(cap, cfg.M, thr)
    emit({"phase": "k6_vs_plain", "case": "operating_point", **k6_cmp})

    # ---- phase 4: K5 vs plain on six captures ----
    short = cfg.replace(pid_max=20)  # the widths of cfg, a short payload

    def capture(c, **kw):
        s = simulator.ChannelSpec(**{**dict(snr_db=30.0, seed=42), **kw})
        return simulator.simulate_capture(c, s, device=dev)[0]

    k5_cmp = check_sync("operating_point", cap, cfg)
    x64 = capture(short, delay=64)  # the earliest fire M=2048 allows
    first = check_sync("delay_64", x64, cfg)
    tiny = tiny_config(bit_exact=False)
    first_m64 = check_sync("delay_64_M64", capture(tiny, delay=64), tiny)
    require(first_m64["tile"] == 0, f"no fire in the first tile: {first_m64}")
    # the same frame, cut to end 5 samples short of t*'s tile end
    tile = k5._kernel().sc_sync_tile_len(cfg.M)
    t_end = max(first["tile"] * tile + tile - 5, first["t_star"] + 1)
    last = check_sync("fire_in_last_tile", x64[:, :t_end].contiguous(), cfg)
    require(last["synced"] and last["tile"] == last["last_tile"],
            f"no fire in the last tile: {last}")
    none = check_sync("noise_only", noise, cfg)
    require(not none["synced"], "noise-only capture fired")
    zeros = check_sync("leading_zeros_1e5", torch.nn.functional.pad(
        capture(short, delay=300), (100_000, 0)), cfg)
    require(all(r["synced"] for r in (k5_cmp, first, first_m64, zeros)),
            "a capture with a frame did not sync")
    del noise

    # ---- phase 5: the main path at the reference operating point ----
    dec = rx.make_decoder(cfg, device=dev, input_format="planes")
    r, counts = drive(lambda: dec(re, im))
    launches = counts["payload_fused_strip"]
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
          "evm_percent": rep.evm_percent, "launches": counts,
          "k1_launches_per_decode": launches, **e2e})

    # ---- phase 6: the same decode with the one-pass sync kernel K5 ----
    dec_pallas = rx.make_decoder(cfg, device=dev, input_format="planes",
                                 sync_impl="pallas")
    rp, counts_pallas = drive(lambda: dec_pallas(re, im))
    require(counts_pallas["sc_sync"] == 1
            and counts_pallas["payload_fused_strip"] == 1,
            f"sync_impl='pallas' launches {counts_pallas}")
    for f in INT_FIELDS:
        require(torch.equal(getattr(rp, f), getattr(r, f)),
                f"sync_impl='pallas' differs from the default in {f}")
    rep_p = report.score(rp, tx_data, cfg)
    require(all(s == 0.0 for s in rep_p.symbol_error_rate),
            f"SER {rep_p.symbol_error_rate} with sync_impl='pallas'")
    emit({"phase": "sync_pallas", "launches": counts_pallas,
          "int_fields_equal_default": True,
          "ser_percent": rep_p.symbol_error_rate,
          "cfo_hat": float(rp.cfo_hat), "cfo_hat_default": float(r.cfo_hat)})

    # ---- phase 7: keep_debug (the full-rate scan's metric from K6) ----
    dec_debug = rx.make_decoder(cfg, device=dev, input_format="planes",
                                keep_debug=True)
    rd, counts_debug = drive(lambda: dec_debug(re, im))
    require(counts_debug["sc_metric"] == 1
            and counts_debug["payload_fused_strip"] == 1,
            f"keep_debug launches {counts_debug}")
    require(rd.metric is not None and rd.metric.dtype == torch.float32
            and tuple(rd.metric.shape) == (S, T), "keep_debug metric")
    require(rd.mf_traces is not None, "keep_debug keeps no traces")
    for f in INT_FIELDS:
        require(torch.equal(getattr(rd, f), getattr(r, f)),
                f"keep_debug differs from the default in {f}")
    emit({"phase": "keep_debug", "launches": counts_debug,
          "metric": [list(rd.metric.shape), str(rd.metric.dtype)],
          "mf_traces": list(rd.mf_traces.shape),
          "int_fields_equal_default": True})
    del rd

    # ---- phase 8: the CFO config at full width ----
    cfg_cfo = ModemConfig(pid_max=1000, bit_exact=False, correct_cfo=True,
                          sync_fallback=True, smooth_channel=True)
    spec_cfo = simulator.ChannelSpec(snr_db=30.0, delay=5000, seed=42,
                                     cfo_subcarriers=0.05)
    cap_c, tx_c, _ = simulator.simulate_capture(cfg_cfo, spec_cfo, device=dev)
    re_c, im_c = cap_c.real.contiguous(), cap_c.imag.contiguous()
    del cap_c
    dec_cfo = rx.make_decoder(cfg_cfo, device=dev, input_format="planes")
    rc, counts_cfo = drive(lambda: dec_cfo(re_c, im_c))
    require(counts_cfo["payload_fused_strip"] == 1,
            f"CFO config launches {counts_cfo}")
    rep_c = report.score(rc, tx_c, cfg_cfo)
    cfo_err = abs(float(rc.cfo_hat) - 0.05)
    emit({"phase": "cfo_config", "launches": counts_cfo,
          "synced": rep_c.synced, "cfo_hat": float(rc.cfo_hat),
          "cfo_coarse": float(rc.cfo_coarse), "cfo_abs_err": cfo_err,
          "ser_percent": rep_c.symbol_error_rate,
          "evm_percent": rep_c.evm_percent})
    require(rep_c.synced, "CFO capture did not sync")
    require(cfo_err < 1e-3, f"cfo_hat {float(rc.cfo_hat)} vs 0.05")
    require(all(s == 0.0 for s in rep_c.symbol_error_rate),
            f"SER {rep_c.symbol_error_rate} in the CFO config")

    # ---- phase 9: golden capture (M=64) ----
    manifest = json.loads((GOLDEN / "manifest.json").read_text())
    gcfg = ModemConfig.from_json(json.dumps(manifest["config"]))
    chans = [np.fromfile(GOLDEN / f"rx{s + 1}.dat", dtype=np.complex64)
             for s in range(gcfg.num_streams)]
    n = min(len(c) for c in chans)
    gcap = np.stack([c[:n] for c in chans])
    g, counts_golden = drive(lambda: rx.make_decoder(gcfg, device=dev)(gcap))
    exp_data = np.load(GOLDEN / "expected_rx_data.npy")
    exp_G = np.load(GOLDEN / "expected_G.npy")
    got_data = g.rx_data.cpu().numpy()
    require(np.array_equal(got_data, exp_data),
            f"golden rx_data: {int((got_data != exp_data).sum())} mismatches")
    np.testing.assert_allclose(g.G.cpu().numpy(), exp_G, rtol=1e-4, atol=1e-6)
    emit({"phase": "golden", "rx_data_equal": True, "G_rtol": 1e-4,
          "k1_launches": counts_golden["payload_fused_strip"]})

    # ---- phase 10: times (CUDA events, medians over TIMING_ITERS) ----
    # the two sync paths in turns: default, pallas, pallas, default
    t_dec = cuda_ms(lambda: dec(re, im))
    t_pal = cuda_ms(lambda: dec_pallas(re, im))
    t_pal2 = cuda_ms(lambda: dec_pallas(re, im))
    t_dec2 = cuda_ms(lambda: dec(re, im))
    t_cfo = cuda_ms(lambda: dec_cfo(re_c, im_c))
    t_k1 = cuda_ms(lambda: pf.payload_fused_strip(
        p_re, p_im, r.W, r.normalize_gain, tab, norm, **kw))
    t_plain = cuda_ms(lambda: pf.payload_tail_reference(
        p_re, p_im, r.W, r.normalize_gain, tab, norm, **kw))
    sync_args = (cap, cfg.M, cfg.cp_len, thr)
    t_k5 = cuda_ms(lambda: k5.sc_sync_fused(*sync_args))
    t_k5_plain = cuda_ms(lambda: k5.sc_sync_reference(*sync_args))
    t_k6 = cuda_ms(lambda: k6.sc_metric_fused(cap, cfg.M))
    t_k6_plain = cuda_ms(lambda: k6.sc_metric_reference(cap, cfg.M))
    emit({"phase": "times", "card": card, "iters": TIMING_ITERS,
          "decode": t_dec, "decode_sync_pallas": t_pal,
          "decode_sync_pallas_again": t_pal2, "decode_again": t_dec2,
          "decode_cfo_config": t_cfo,
          "k1": t_k1, "plain_tail": t_plain,
          "k5": t_k5, "plain_k5": t_k5_plain,
          "k6": t_k6, "plain_k6": t_k6_plain,
          "decode_samples_per_s": S * T / (t_dec["median_ms"] * 1e-3)})

    # ---- phase 11: where the decode's time goes ----
    # stage times before the profiler sessions: the host's launches run
    # slower after them, as the decode timed again afterwards shows
    stage_ms = stage_times(cfg, re, im, int(r.sync_index))
    busy = device_busy(lambda: dec(re, im))
    busy_pal = device_busy(lambda: dec_pallas(re, im))
    t_after = cuda_ms(lambda: dec(re, im))
    emit({"phase": "stages", "card": card, "iters": TIMING_ITERS,
          "stage_ms": stage_ms,
          "k1_ms": t_k1["median_ms"], "decode_ms": t_dec["median_ms"],
          "decode_sync_pallas_ms": t_pal["median_ms"],
          "decode_ms_after_profiler": t_after["median_ms"],
          "profiled_decodes": 5,
          "device_busy_ms_per_decode": busy["busy_ms"],
          "device_idle_share": (None if busy["busy_ms"] is None else
                                1.0 - busy["busy_ms"] / t_dec["median_ms"]),
          "device_kernels_per_decode": busy["kernels"],
          "longest_kernels_us": busy["top_kernels_us"],
          "sync_pallas": {
              "device_busy_ms_per_decode": busy_pal["busy_ms"],
              "device_idle_share": (
                  None if busy_pal["busy_ms"] is None else
                  1.0 - busy_pal["busy_ms"] / t_pal["median_ms"]),
              "device_kernels_per_decode": busy_pal["kernels"],
              "longest_kernels_us": busy_pal["top_kernels_us"]}})

    emit({"kernels": [{
        "name": "payload_fused_strip",
        "route": "cuda",
        "source": "rub_mimo_tpu_torch/kernels/csrc/payload_fused_strip.cu",
        "replaces": "rub_mimo_tpu/kernels/payload_fused.py:548",
        "launches": launches,
        "max_abs_err": main_cmp["max_abs_err"],
        "ms": t_k1["median_ms"],
        "plain_ms": t_plain["median_ms"],
    }, {
        "name": "sc_sync",
        "route": "cuda",
        "source": "rub_mimo_tpu_torch/kernels/csrc/sc_sync.cu",
        "replaces": "rub_mimo_tpu/kernels/sc_sync.py:168",
        "launches": counts_pallas["sc_sync"],
        "max_abs_err": k5_cmp["corr_abs_err"],
        "ms": t_k5["median_ms"],
        "plain_ms": t_k5_plain["median_ms"],
    }, {
        "name": "sc_metric",
        "route": "cuda",
        "source": "rub_mimo_tpu_torch/kernels/csrc/sc_metric.cu",
        "replaces": "rub_mimo_tpu/kernels/sc_metric.py:85",
        "launches": counts_debug["sc_metric"],
        "max_abs_err": k6_cmp["max_abs_err"],
        "ms": t_k6["median_ms"],
        "plain_ms": t_k6_plain["median_ms"],
    }]})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})


if __name__ == "__main__":
    main()
    sys.exit(0)
