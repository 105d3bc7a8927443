#!/usr/bin/env python3
"""K3 (equalize + demap) and K4 (hard demap) of
rub_mimo_tpu_torch/kernels/csrc/eq_demap.cu on one NVIDIA GPU, with K1
and K2 beside them.

    python3 scripts/time_k34.py [--root DIR] [--calls 10]

Runs torch.profiler over ``--calls`` calls of each kernel at the shapes
its paths give it:

- ``k3_operating_point``: K3 on chip_smoke.check_payload_kernels's case
  (the operating point's [2, 1000, 2048] ARB32OPT frames of seeded
  random symbols through a seeded well-conditioned 2x2 channel);
- ``k3_near_points``: K3 at the same shape on frequency-domain symbols
  whose equalized values are ARB32OPT points plus noise at 30 dB, as a
  decode hands it;
- ``k4_xla_qam16``: K4 on the rx_sig of the mimo_2x2_zf preset's
  ``payload_impl="xla"`` decode ([2, 1000, 2048] 16-QAM);
- ``k4_arb32``, ``k4_qam256``: K4 on seeded complex Gaussian symbols
  (0.8 per part) at [2, 1000, 2048] ARB32OPT and [1, 1000, 50] QAM256,
  as chip_smoke.py's k4_vs_plain phase draws them;
- ``k4_tracking_block``: K4 on one track_channel block, [2, 8, 2048]
  ARB32OPT, drawn as chip_smoke.py draws it;
- ``k1``, ``k2``: the fused payload tails at the operating point on
  seeded random payloads.

Each is held against its plain version first (decisions equal but at
near-ties, ``chip_smoke.compare``).  ``--root`` imports
rub_mimo_tpu_torch from DIR instead of this checkout, so that two
versions (an unpacked parent commit and this one) are timed in one run
on one card; the timer is this checkout's ``chip_smoke.device_busy``
either way.  Prints the card line, then one JSON line: per shape the
device busy time per call (mean and median over the calls), each
kernel's median µs per launch, the bytes bound and its share, and K3/K4's
grids where the wrapper reports them; the compiler's report
(``-Xptxas -v``) and the load instructions per kernel in the library's
SASS (``cuobjdump -sass``).  Exits non-zero without a CUDA device or on a
mismatch."""

from __future__ import annotations

import argparse
import json
import re
import subprocess
import sys
from collections import Counter
from pathlib import Path

import numpy as np
import torch

REPO = Path(__file__).resolve().parents[1]
SASS_OPS = re.compile(r"\b(LDS|LDC|LDG|STG|STS|LDSM)(\.[A-Z0-9_.]+)?\b")


def sass_counts(lib: Path) -> dict:
    """Per kernel in the library: the count of each shared, constant and
    global load and store instruction in its SASS."""
    cuobjdump = Path("/usr/local/cuda/bin/cuobjdump")
    if not cuobjdump.exists():
        return {"error": "no cuobjdump"}
    text = subprocess.run([str(cuobjdump), "-sass", str(lib)],
                          capture_output=True, text=True,
                          timeout=120).stdout
    out: dict = {}
    name = None
    for line in text.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            name = m.group(1)
            out[name] = Counter()
        elif name is not None:
            for op in SASS_OPS.finditer(line.split("/*")[-2]
                                        if line.count("/*") >= 2 else line):
                out[name][op.group(0)] += 1
    return {k: dict(sorted(v.items())) for k, v in out.items()}


def lsu_wavefronts(k34, y: torch.Tensor, table, per_thread: int) -> dict:
    """Shared-memory wavefronts per warp and symbol of the region search
    on symbols y, modelled with the bank rule (no ncu on the card's
    machine): a 4-byte gather costs the most distinct words that one of
    the 32 banks holds among the warp's lanes; a 16-byte gather runs in
    four phases of eight lanes, each costing the most distinct points
    among its lanes that share a bank group (point mod 8).  Lane l of
    warp w takes symbol per_thread (32 w + l) + e in its e-th search, as
    K4 lays them out (K3: per_thread = 1, one stream at a time).  The
    candidates' loads count only lanes whose cell has two or more."""
    words = torch.as_tensor(k34.region_table(table).astype(np.int64),
                            device=y.device)
    box, scale = (float(v) for v in k34.region_geometry(table))
    yr, yi = y.real.reshape(-1), y.imag.reshape(-1)
    n = (yr.numel() // (32 * per_thread)) * 32 * per_thread
    yr, yi = yr[:n], yi[:n]
    inside = (yr.abs() < box) & (yi.abs() < box)
    ix = ((torch.where(inside, yr, 0) + box) * scale).long().clamp(
        max=k34.GRID - 1)
    iy = ((torch.where(inside, yi, 0) + box) * scale).long().clamp(
        max=k34.GRID - 1)
    cell = iy * k34.GRID + ix
    w = words[cell]
    # [warp, e, lane]
    shape = (n // (32 * per_thread), 32, per_thread)
    cell = cell.reshape(shape).transpose(1, 2)
    w = w.reshape(shape).transpose(1, 2)
    live = inside.reshape(shape).transpose(1, 2)

    def worst(key, group, active, n_groups):
        """max over groups of the distinct keys among active lanes."""
        k = torch.where(active, key, -1)
        srt = k.sort(dim=-1).values
        first = torch.ones_like(srt, dtype=torch.bool)
        first[..., 1:] = srt[..., 1:] != srt[..., :-1]
        g = torch.where(srt >= 0, group(srt), n_groups)
        cnt = torch.zeros(*srt.shape[:-1], n_groups + 1,
                          dtype=torch.int64, device=srt.device)
        cnt.scatter_add_(-1, g, first.long())
        return cnt[..., :n_groups].amax(dim=-1)

    word_wf = worst(cell, lambda c: c % 32, live, 32)
    slots = [(w >> (8 * s)) & 0xFF for s in range(k34.SLOTS)]
    many = live & (slots[1] != slots[0])
    point_wf = torch.zeros_like(word_wf)
    for s in range(k34.SLOTS):
        act = many if s == 0 else many & (slots[s] != slots[s - 1])
        if s > 1:
            act = act & (slots[s - 1] != slots[s - 2])
        q = slots[s].reshape(*slots[s].shape[:-1], 4, 8)
        a = act.reshape(q.shape)
        point_wf += worst(q, lambda v: v % 8, a, 8).sum(dim=-1)
    per_symbol = (word_wf + point_wf).float().sum() / (n / 32)
    return {"per_warp_and_symbol": float(per_symbol),
            "cell_word": float(word_wf.float().sum() / (n / 32)),
            "candidates": float(point_wf.float().sum() / (n / 32)),
            "outside_box_share": float((~inside).float().mean())}


def gaussian(rng, shape, scale, dev):
    return torch.as_tensor(
        ((rng.standard_normal(shape) + 1j * rng.standard_normal(shape))
         * scale).astype(np.complex64), device=dev)


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=str(REPO))
    ap.add_argument("--calls", type=int, default=10)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("time_k34.py: no CUDA device")
    sys.path.insert(0, str(REPO))
    from chip_smoke import (HBM_BYTES_PER_S, card_line, check_payload_kernels,
                            compare, device_busy, require)

    sys.path.insert(0, str(Path(args.root).resolve()))
    from rub_mimo_tpu_torch import ModemConfig, Modulation
    from rub_mimo_tpu_torch.detect import zf
    from rub_mimo_tpu_torch.io import simulator
    from rub_mimo_tpu_torch.kernels import _build
    from rub_mimo_tpu_torch.kernels import eq_demap as k34
    from rub_mimo_tpu_torch.kernels import payload_fused as pf
    from rub_mimo_tpu_torch.models import presets
    from rub_mimo_tpu_torch.ofdm import constellation
    from rub_mimo_tpu_torch.pipeline import rx

    card = card_line()
    print(card, flush=True)
    dev = torch.device("cuda")
    cfg = ModemConfig(pid_max=1000, bit_exact=False)
    S, M, n_sym, sym = 2, cfg.M, cfg.pid_max, cfg.symbol_len
    a32 = constellation.table(Modulation.ARB32OPT)
    q256 = constellation.table(Modulation.QAM256)
    norm = np.float32(1.0 / np.sqrt(M))

    cases = check_payload_kernels(dev, cfg)  # also holds K2-K4, K7 to plain
    X3, W3, g3, _ = cases["eq_demap"]["args"]
    # equalized values that are ARB32OPT points plus noise at 30 dB: X =
    # G (s + n) / (W gain) per subcarrier, with W gain = G^-1
    rng = np.random.default_rng(34)
    G = torch.linalg.inv(W3 * g3[:, None, None])
    s = torch.as_tensor(a32, device=dev)[torch.as_tensor(
        rng.integers(0, len(a32), (S, n_sym, M)), device=dev)]
    s = s + gaussian(rng, (S, n_sym, M), np.sqrt(10 ** -3.0 / 2), dev)
    X_near = torch.einsum("mij,jkm->ikm", G, s).contiguous()

    zcfg, zspec = presets.mimo_2x2_zf()
    zcap = simulator.simulate_capture(zcfg, zspec, device=dev)[0]
    zdec = rx.make_decoder(zcfg, device=dev, input_format="planes",
                           payload_impl="xla")
    y_xla = zdec(zcap.real.contiguous(),
                 zcap.imag.contiguous()).rx_sig.contiguous()
    q16 = constellation.table(zcfg.modulation)
    del zcap

    rng = np.random.default_rng(341)
    y_a32 = gaussian(rng, (S, n_sym, M), 0.8, dev)
    y_q256 = gaussian(rng, (1, n_sym, 50), 0.8, dev)
    y_trk = gaussian(np.random.default_rng(126), (S, 8, M), 0.8, dev)

    rng = np.random.default_rng(263)
    p = torch.as_tensor(rng.standard_normal(
        (2, S, n_sym * sym)).astype(np.float32), device=dev)
    x2, W2, g2, _, _ = cases["payload_fused"]["args"]
    kw = dict(n_sym=n_sym, symbol_len=sym, cp_len=cfg.cp_len)

    def k3(X):
        return (lambda: k34.eq_demap(X, W3, g3, a32),
                lambda: k34.eq_demap_reference(X, W3, g3, a32),
                X.numel() * 8 + W3.numel() * 8 + g3.numel() * 4
                + X.numel() * 12, a32)

    def k4(y, tab):
        return (lambda: (None, k34.demap(y, tab)),
                lambda: (y, constellation.hard_demap(y, tab)),
                y.numel() * 12, tab)

    shapes = {
        "k3_operating_point": k3(X3),
        "k3_near_points": k3(X_near),
        "k4_xla_qam16": k4(y_xla, q16),
        "k4_arb32": k4(y_a32, a32),
        "k4_qam256": k4(y_q256, q256),
        "k4_tracking_block": k4(y_trk, a32),
        "k1": (lambda: pf.payload_fused_strip(p[0], p[1], W2, g2, a32, norm,
                                              **kw),
               lambda: pf.payload_tail_reference(p[0], p[1], W2, g2, a32,
                                                 norm, **kw),
               2 * S * n_sym * M * 4 + W2.numel() * 8 + g2.numel() * 4
               + S * n_sym * M * 12, a32),
        "k2": (lambda: pf.payload_fused(x2, W2, g2, a32, norm),
               lambda: pf.payload_fused_reference(x2, W2, g2, a32, norm),
               x2.numel() * 8 + W2.numel() * 8 + g2.numel() * 4
               + S * n_sym * M * 12, a32),
    }
    lib = _build.build("eq_demap")
    out = {"card": card, "root": str(Path(args.root).resolve()),
           "calls": args.calls, "shapes": {},
           "ptxas": [ln.strip() for ln in
                     Path(str(lib) + ".log").read_text().splitlines()
                     if "registers" in ln or "spill" in ln
                     or "Compiling" in ln],
           "sass": sass_counts(lib)}
    for name, (fn, ref, n_bytes, tab) in shapes.items():
        got_sig, got = fn()
        ref_sig, ref_data = ref()
        cmp = compare(got_sig, got, ref_sig, ref_data, tab)
        busy = device_busy(fn, n=args.calls)
        require(busy["busy_ms"] is not None,
                f"{name}: the profiler recorded no device activity")
        res = {"shape": list(ref_data.shape), "points": len(tab),
               "busy_us": busy["busy_ms"] * 1e3,
               "busy_us_median": (None if busy["busy_ms_median"] is None
                                  else busy["busy_ms_median"] * 1e3),
               "kernels_us": busy["kernels_us"],
               "bound_us": n_bytes / HBM_BYTES_PER_S * 1e6,
               "mismatches": cmp["mismatches"],
               "mismatch_margins": cmp["mismatch_margins"][:8]}
        res["bound_share"] = res["bound_us"] / (res["busy_us_median"]
                                                or res["busy_us"])
        # the parent's scan: per point and warp, three 16-byte broadcast
        # loads for four points (its SASS), so 0.75 wavefronts a point
        res["full_scan_wavefronts_per_warp_and_symbol"] = 0.75 * len(tab)
        if hasattr(k34, "launch_geometry") and name.startswith("k3"):
            res["geometry"] = k34.launch_geometry("eq_demap", S, M, n_sym)
            res["wavefronts"] = lsu_wavefronts(k34, ref_sig, tab, 1)
        elif hasattr(k34, "launch_geometry") and name.startswith("k4"):
            y = ref_sig
            res["geometry"] = k34.launch_geometry(
                "demap", y.numel(), int(y.data_ptr() % 16 != 0))
            res["wavefronts"] = lsu_wavefronts(
                k34, y, tab, res["geometry"]["per_thread"])
        out["shapes"][name] = res
    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
