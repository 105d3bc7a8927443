#!/usr/bin/env python3
"""Bring-up check of the PyTorch / CUDA port (rub_mimo_tpu_torch) on one
NVIDIA GPU.

    python3 chip_smoke.py

Builds the port's CUDA kernels from the sources in this checkout (K1 the
strip-fused payload tail, K2 the fused payload tail, K3 equalize +
demap, K4 the hard demap, K5 the one-pass sync, K6 the S&C metric, K7
the CP strip, K8 the halo exchange, the Viterbi decoder and the soft
LLRs with their rows; one nvcc per source, all at once)
and holds each against its plain PyTorch version: K1 and K2 on seeded
random payloads (the operating point, one frame per block, M = 64 and
4096, an odd CP with an unaligned plane, 3 and 4 streams, 2 to 64
points; the persistent grids printed), K6 on a seeded random capture,
the operating-point capture and the (4, 1) sharded full-rate stage A's
stacked rows of it (one card's eight, and one card's two across cards;
NaN exactly on the windows of zeros), K5 on eight captures (the operating
point, the earliest fire at full width and at M=64, a fire in the last
chunk of that frame and of the operating point's, noise only, 10^5
leading zeros, and seeded noise of the operating point's length, which
never fires), K7 on complex64 and float32 payloads (bit for bit), K4
at three widths and point counts and on the symbols the "xla" decode
hands it, K3 and K2 on seeded random symbols, K4 and K3 on every
modulation, BPSK to QAM256, on symbols that reach each path of their
decision-region search (demap_by_modulation: against the plain version
and, bit for bit, against the kernel's own full scan), K8 bit for bit on seeded
random halos of four one-card meshes and on the operating point's own
halos.  Then it decodes the reference operating point end to end
through ``make_decoder(..., input_format="planes")`` on each path this
port offers: the default coarse sync,
``sync_impl="pallas"`` (K5), ``keep_debug=True`` (K6), the CFO config
(correct_cfo, sync_fallback, smooth_channel) on a capture with a CFO;
the mimo_2x2_zf preset under the four payload impls ("auto" K1, "fused"
K7 + K2, "eqdemap" K7 + K3, "xla" K7 + K4); the generic payload tail's
modes and detectors at full width (siso_loopback, guard bands with and
without normalize_rx_scale, Alamouti, RX_DIVERSITY, SIC, ML, channel
and phase tracking); and the wifi_like preset at its own width against
the port's CPU decode of the same capture; the sharded decode
(parallel.decode_sharded) of the operating point on one-card meshes,
(4, 1) and (2, 2) with the ppermute halo (coarse sync, K1 on every
shard) and (4, 1) with K8's (full-rate sync: K8, K6, K1 on every shard),
each against the single-device decode; and mimo_4x4_wideband at full
width, single-device and sharded on (4, 1).  On 2 or more cards its
across_cards phase holds K8 pulling halos from other cards bit for bit
against its plain version (one launch per card), decodes the operating
point sharded across the cards ((2, 1) on two; (4, 1) and (2, 2) on
four, ``pallas_dma``, with ppermute (n, 1) beside it) and, on four,
mimo_4x4_wideband (4, 1) with ``pallas_dma``, each equal to the single
decode with SER 0, and serves 8 captures over the cards and over one
card, each equal to its single decode; on one card it prints
{"phase": "across_cards", "run": false, "cards": 1}.  It serves, through
``make_serving_decoder``, eight operating-point captures (the serving
seeds, stacked as planes) from one CUDA graph of the decode (K5, then
K1) and one capture each of the CFO config, mimo_2x2_zf "xla" (K5, K7,
K4), track_channel (K5, K7, K4 per block) and mimo_4x4_wideband with the
full-rate sync (K6, K1): each capture equal to the eager decode with the
same options and SER 0, one replay's kernels counted by name with
torch.profiler, per-capture times beside the eager decodes, and the
device's busy time and idle share of a replay; it runs an eager decode
of each of those paths under torch.cuda.set_sync_debug_mode("error")
(no_host_sync), and decode_all on a full-width capture of two bursts
(both found, SER 0, the input unchanged) and on a one-burst capture.
It streams (pipeline.streaming) the operating point through
decode_stream in chunks of 65,536 and 4,096 and through push_block (8
chunks a call), each equal to the eager decode (sync_index, the global
decode_start, decisions but at near-ties, SER 0); the CFO config (SER
0, cfo_hat within 1e-3 of the eager decode's); track_channel in 8-frame
groups, held against the port's streamed decode on the CPU; the
two-burst capture, each burst equal to decode_all's; 64 chunks of
seeded noise through push_block (no fire, one read a block); and a
stretch of payload pushes under set_sync_debug_mode("error"), with K6
and K1 at the stream's shapes against their plain versions; its
streaming lines print IQ samples/s for the stream and its payload
phase, ms a payload push, host reads and kernels a call, and the
device's busy time and idle share over the stream.
It runs the coded chain (ofdm.fec) at the operating point: a payload of
encode_payload(seed=42) at rates 1/2, 2/3 and 3/4 through the port's TX
and channel, the default planes decode (K1) and decode_payload (the
soft-LLR rows kernel, csrc/soft_llr.cu's soft_llr_rows_kernel: the LLRs
written straight into the Viterbi's window rows, and the Viterbi kernel,
csrc/viterbi.cu, neither with a TPU counterpart: they replace the JAX
package's XLA ops and lax.scan pair; one launch each a decode, and at
rate 1/2 torch.profiler's kernels a call are the two and at most one
copy of the decoded bits, nothing else), BER 0 on both lanes; the back
end's stages (the parent's three: LLRs, deinterleave and depuncture, the
rows' pads and windows; then the rows kernel, the Viterbi on its rows,
the whole back end, and the back end's peak memory beside the old
chain's) timed; encode_data / decode_data of a full payload of seeded
bytes (CRC and bytes exact); decode_payload_ml on the ML QPSK config
(the rows kernel's LLR-input instance, BER 0); soft_demodulate_llr (the
soft_llr kernel: the same source with the identity geometry).  The rows
kernel is held value for value against soft_llr_rows_plain on the
operating point's rx_sig at the three rates, on its LLRs (the LLR-input
instance) and on seeded symbols of every modulation with NaN, +-Inf and
1e30 rows, interleaved or not, one row or windows of 4096, noise_var a
number, a device tensor and 0.  The soft-LLR kernel is held value for
value against soft_llr_plain on the operating point's rx_sig and on
seeded symbols of every modulation (an odd count and one symbol, NaN,
+-Inf and 1e30 rows), noise_var a number and a device tensor.  The
Viterbi kernel is held bit for bit against viterbi_plain on the
operating point's 2,500 windows, a 16,390-step codeword, seeded rows
with exact ties and +-1e4 pads, all-zero rows, and row counts that
leave a warp's lane groups part empty (1, 2, 3, 5, 37 rows; 1, 31, 33
steps); it is timed there, beside the previous kernel's time quoted
(VITERBI_BEFORE_QUOTED).  decode_with_sfo runs on the full-geometry SFO
case (pid_max=64) at 20 and 100 ppm
(|ppm_hat - ppm| < 0.1 ppm + 2, SER < 0.005) and at the operating point
at 20 ppm (printed); the streaming decoder's live SFO correction on
tests/test_sfo_streaming.py's three-burst 100 ppm capture (its
thresholds, and equal to the port's CPU stream) and on the same layout
at full geometry, 20 ppm (printed).
It drives the port's command line (apps/cli.py, through cli.main in this
process) at its default geometry, the operating point: run (SER 0, K1
once a decode, decisions equal to rx.decode's), the checkpoint it saves
resumed from frames 0 and 500 (equal to the decode), transmit and then
decode through files (the TX files through the simulated channel, SER
0), listen on 127.0.0.1 fed by send as a process of its own (the native
SocketReader, chunks of 4096, SER 0, samples/s a stream, K6/K1/K4
launches), run with 1 dB / 5 degrees of IQ imbalance and a DC offset
without and with --frontend-comp (SER, w against its closed form, the
front end's device time against its bytes bound), the streamed front end
(StreamingDecoder(frontend_comp=True), equal to decode_with_frontend, no
host read in its payload phase), --precoded, --fec at rates 1/2 and 3/4,
--send-file of 64 KB, and --profile with --trace-dir.  The native ingest
library is built (g++) with the kernels.
It decodes the operating point across processes (parallel.multiprocess,
one process a rank): on one card 2 gloo ranks of 2 time shards on
cuda:0 at (4, 1), with pallas_dma (K8 publishing, waiting on the other
rank's flag word and pulling through its IPC-mapped buffer in one launch
a rank a decode, bit for bit against its plain version; then 200
back-to-back exchanges a rank with no host sync between them, bit for
bit, with the host syncs and launches a call counted, the kernel's
publish, wait and pull in µs from its own marks, and a call's host time
alone and synchronized) and ppermute; on 2+ cards one NCCL rank a card at
(n, 1), and on four mimo_4x4_wideband (4, 1) with pallas_dma; every rank
equal to its single decode with SER 0, rank 0's wall ms beside the
single-controller decode of the same mesh (multiprocess lines).  It
replays the operating point through apps.live_view into a LiveView on
127.0.0.1 (1,000 frames, SER 0 from its frames, samples/s beside
decode_stream) and runs apps.analyze on `cli run --log-dir`'s artifacts
(its SER equal to the run's); report_html runs where matplotlib is
installed (apps lines).
Every launch count is set to 0 just before a path runs and read just
after.  It decodes the
checked-in golden capture, times the decodes and the kernels with CUDA
events, and breaks the default decode down by stage (CUDA events per
stage, torch.profiler for the device's busy time), and times each
payload_impl's whole tail (strip to decisions) on the card, the payload
window's gather at a device start against the copy at host ints it
replaced (payload_window), K6 at its
three shapes beside its persistent grid (its times before its
redesign are quoted there, labelled as not measured by this run:
K6_BEFORE_QUOTED), K4 on one track_channel block, K1 and
K2 warm and after a 256 MB write evicts the L2, K1 at one (4, 1)
shard's call, and K1 with 2 to 64 demap points, with the SM clock under
load.  Each phase prints one JSON line; any failed check raises,
so the exit code is non-zero.  The line before the last lists every
kernel with its launches on its path, its error against its plain
version, its time, the plain version's time, its bound on this card, its
share of that bound and, where one PyTorch call computes the same
function, that call's time; the line before it has the script's wall
seconds.  The last line is the device summary
{"ok": true, "device": {...}}.  There is no CPU path: without a CUDA
device the script exits non-zero before printing anything.
"""

from __future__ import annotations

import importlib
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
# the same for a channel-tracked rx_sig: each refit goes through a matrix
# inverse, so rounding grows from group to group (tests/test_torch_
# streaming.py and test_torch_detectors.py hold tracked outputs to 1e-3)
TRACKED_SIG_REL_TOL = 1e-3
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
MODE_ITERS = 10      # timing runs of each generic-tail decode
# the card's published peaks (H100 SXM data sheet, dense, at 700 W)
HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS = 67e12
L2_FLUSH_BYTES = 256 << 20  # written before a cold call: 5x the 50 MB L2
NVLINK_BYTES_PER_S = 450e9  # one way, card to card (H100 SXM data sheet)
# channel seeds of the across-cards serving check's 8 captures, the
# operating point's seeds from 100 whose decode has SER 0 at 30 dB (101,
# 106, 109 and 111 do not, on the CPU decode as well)
SERVING_SEEDS = (100, 102, 103, 104, 105, 107, 108, 110)

# kernel -> (module in rub_mimo_tpu_torch.kernels, wrapper, CUDA source,
# the TPU kernel it replaces)
KERNELS = {
    "payload_fused_strip": ("payload_fused", "payload_fused_strip",
                            "payload_fused_strip",
                            "rub_mimo_tpu/kernels/payload_fused.py:548"),
    "payload_fused": ("payload_fused", "payload_fused", "payload_fused",
                      "rub_mimo_tpu/kernels/payload_fused.py:317"),
    "eq_demap": ("eq_demap", "eq_demap", "eq_demap",
                 "rub_mimo_tpu/kernels/eq_demap.py:176"),
    "demap": ("eq_demap", "demap", "eq_demap",
              "rub_mimo_tpu/kernels/eq_demap.py:163"),
    "sc_sync": ("sc_sync", "sc_sync_fused", "sc_sync",
                "rub_mimo_tpu/kernels/sc_sync.py:168"),
    "sc_metric": ("sc_metric", "sc_metric_fused", "sc_metric",
                  "rub_mimo_tpu/kernels/sc_metric.py:85"),
    "cp_strip": ("cp_strip", "cp_strip", "cp_strip",
                 "rub_mimo_tpu/kernels/cp_strip.py:62"),
    "ring_shift_right": ("halo_dma", "ring_shift_right", "halo_dma",
                         "rub_mimo_tpu/kernels/halo_dma.py:68"),
    # no TPU kernel: the JAX package's Viterbi is a lax.scan pair
    "viterbi": ("viterbi", "viterbi", "viterbi",
                "rub_mimo_tpu/ofdm/fec.py:141"),
    # no TPU kernel: the JAX package's soft LLRs are XLA ops
    "soft_llr": ("soft_llr", "soft_llr", "soft_llr",
                 "rub_mimo_tpu/ofdm/constellation.py:222"),
    # no TPU kernel: the same LLRs, then _decode_from_llrs's deinterleave,
    # depuncture and viterbi_decode's window pads, all XLA ops
    "soft_llr_rows": ("soft_llr", "soft_llr_rows", "soft_llr",
                      "rub_mimo_tpu/ofdm/fec.py:501"),
}
SHARDED_G_RTOL, SHARDED_G_ATOL = 2e-4, 2e-5  # tests/test_parallel.py
# K6's device ms before its redesign as a persistent span scan, quoted in
# the kernel_device_ms line and not measured by this script (the previous
# kernel's torch.profiler busy time per call, median over 10 calls, by
# scripts/time_k6.py --root on a checkout of the commit before it)
K6_BEFORE_QUOTED = {
    "measured_by_this_run": False,
    "source": "scripts/time_k6.py --root <the commit before K6's redesign>",
    "card": "NVIDIA H100 80GB HBM3, 700.00 W",
    "ms": {"operating_point": 0.053339, "sharded_stage_a": 0.053856,
           "one_card_share": 0.0139625}}
# the Viterbi kernel's device ms before its redesign in lane groups, on the
# operating point's 2,500 windows of 4,352 steps, quoted in the
# viterbi_vs_plain line and not measured by this script (torch.profiler
# busy time per call, median over 10 calls, by scripts/time_viterbi.py
# --root on a checkout of the commit before it, in the same run as the
# redesigned kernel)
VITERBI_BEFORE_QUOTED = {
    "measured_by_this_run": False,
    "source": "scripts/time_viterbi.py --root <the commit before the "
              "Viterbi's redesign>",
    "card": "NVIDIA H100 80GB HBM3, 700.00 W",
    # two runs of the parent in one call, beside two of the redesigned
    # kernel (0.577199, 0.577421 ms on seeded rows of the same shape)
    "ms": {"operating_point_rows": [1.069554, 1.0594]}}
# lanes a row of the Viterbi kernel, and the widths measured on the
# operating point's rows before 8 was kept (their times: PERF.md)
VITERBI_LANES, VITERBI_LANES_TRIED = 8, (8, 16, 32)
PAYLOAD_KERNELS = ("payload_fused_strip", "payload_fused", "eq_demap",
                   "demap", "cp_strip")
# kernel -> the names of its device kernels (a graph's launches are
# counted from torch.profiler's kernel names: a replay calls no wrapper)
DEVICE_KERNELS = {
    "payload_fused_strip": ("payload_fused_strip_kernel",),
    "payload_fused": ("payload_fused_kernel",),
    "eq_demap": ("eq_demap_kernel",),
    "demap": ("demap_kernel",),
    "sc_sync": ("sc_sync_scan", "sc_sync_resolve"),
    "sc_metric": ("sc_metric_kernel",),
    "cp_strip": ("cp_strip_kernel",),
    "ring_shift_right": ("ring_shift_right_kernel", "halo_exchange_kernel"),
    "viterbi": ("viterbi_kernel",),
    "soft_llr": ("soft_llr_kernel",),
    "soft_llr_rows": ("soft_llr_rows_kernel",),
}


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


def compare(sig, data, ref_sig, ref_data, table,
            sig_tol: float = SIG_REL_TOL) -> dict:
    """Kernel vs plain: decision mismatches (each must be a near-tie of
    the plain scores) and the rx_sig error relative to the plain RMS
    (at most sig_tol)."""
    torch.cuda.synchronize()
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
        require(out["rel_err"] <= sig_tol,
                f"rx_sig error {out['rel_err']:.3e} > {sig_tol} of RMS")
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


def event_ms(fn, flush=None, iters: int = TIMING_ITERS) -> float:
    """Median CUDA-event ms of one fn() call, warm (L2 holds what the
    last call touched) or cold (flush() first).  A queued ~1 ms sleep
    puts the host ahead of the device, so the events bracket the
    kernel's device time and not the host's launch work."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(iters):
        if flush is not None:
            flush()
        torch.cuda._sleep(2_000_000)
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def clocks_under_load(fn, seconds: float = 1.0) -> dict:
    """Median SM clock (MHz) and power draw (W) that nvidia-smi samples
    every 50 ms while fn() runs back to back."""
    smi = subprocess.Popen(
        ["nvidia-smi", "--query-gpu=clocks.sm,power.draw",
         "--format=csv,noheader,nounits", "-lms", "50"],
        stdout=subprocess.PIPE, text=True)
    try:
        t_end = time.perf_counter() + seconds
        while time.perf_counter() < t_end:
            for _ in range(20):
                fn()
            torch.cuda.synchronize()
    finally:
        smi.terminate()
        out, _ = smi.communicate(timeout=10)
    # the first samples precede the load
    rows = [ln.split(",") for ln in out.strip().splitlines()[2:] if ln]
    if not rows:
        return {"sm_clock_mhz": None, "power_w": None}
    return {"sm_clock_mhz": statistics.median(float(r[0]) for r in rows),
            "power_w": statistics.median(float(r[1]) for r in rows)}


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
        "weights": lambda: weights_mod.weights_for(cfg, G, G),
        "payload_extract": payload_extract,
    }
    return {name: cuda_ms(fn)["median_ms"] for name, fn in stages.items()}


def _union_us(events) -> float:
    """The length of the union of the events' device intervals (µs)."""
    busy_us, end = 0.0, float("-inf")
    for a, b in sorted((e.time_range.start, e.time_range.end)
                       for e in events):
        if b > end:
            busy_us += b - max(a, end)
            end = b
    return busy_us


def _kernel_name(name: str) -> str:
    """A device event's kernel name without namespace, arguments and
    return type ("sc_sync_scan", "Memset")."""
    name = name.replace("(anonymous namespace)::", "").split("(")[0]
    return name.strip().removeprefix("void ")[:60]


def device_busy(fn, n: int = 5, tries: int = 3) -> dict:
    """torch.profiler over n calls of fn: the card's busy ms per call (the
    union of its kernel and copy intervals; across cards, of any card's,
    with each card's own in ``busy_ms_by_card``) and kernels per call.  A
    session that recorded no device activity is run again, up to
    ``tries`` sessions; busy is None when none recorded any.  On one card
    every call runs the same device events, so a session whose count
    does not split into the n calls lost some and is run again too;
    there the events in start order split into the n calls:
    ``busy_ms_median`` is the median of the calls' busy times.
    ``kernels_us`` is each kernel's (and memset's or copy's) median µs
    per launch, ``launches_by_name`` its launches per call."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    sync_all()
    for _ in range(tries):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(n):
                fn()
            sync_all()
        dev = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
        cards = {e.device_index for e in dev}
        if dev and (len(cards) > 1 or len(dev) % n == 0):
            break
    by_card: dict = {}
    for e in dev:
        by_card.setdefault(e.device_index, []).append(e)
    kernels = [e for e in dev if "memcpy" not in e.name.lower()
               and "memset" not in e.name.lower()]
    per_call = None
    if dev and len(by_card) == 1 and len(dev) % n == 0:
        ev = sorted(dev, key=lambda e: e.time_range.start)
        k = len(ev) // n
        per_call = [_union_us(ev[i:i + k]) / 1e3
                    for i in range(0, len(ev), k)]
    by_name: dict = {}
    for e in dev:
        by_name.setdefault(_kernel_name(e.name), []).append(
            e.time_range.elapsed_us())
    return {"busy_ms": _union_us(dev) / n / 1e3 if dev else None,
            "busy_ms_median": (None if per_call is None
                               else statistics.median(per_call)),
            "busy_ms_by_card": {str(c): _union_us(v) / n / 1e3
                                for c, v in sorted(by_card.items())},
            "kernels_us": {k: statistics.median(v)
                           for k, v in sorted(by_name.items())},
            "launches_by_name": {k: len(v) / n
                                 for k, v in sorted(by_name.items())},
            "kernels": len(kernels) / n,
            "top_kernels_us": sorted(
                ((e.name[:60], e.time_range.elapsed_us()) for e in kernels),
                key=lambda x: -x[1])[:5]}


def profiled_us(fn) -> float:
    """The device's busy µs per call of fn, median of 10 profiled calls
    (their mean where the profiler's events do not split into calls)."""
    busy = device_busy(fn, n=10)
    ms = busy["busy_ms_median"] or busy["busy_ms"]
    require(ms is not None, "the profiler recorded no device activity")
    return ms * 1e3

def launch_counts() -> dict:
    """The launch-counted wrappers of the port's kernels, by kernel."""
    return {name: getattr(importlib.import_module(
        f"rub_mimo_tpu_torch.kernels.{mod}"), attr)
        for name, (mod, attr, _, _) in KERNELS.items()}


def bound(n_bytes: float, flops: float) -> dict:
    """The least time the card could take: the larger of the bytes over
    the memory rate and the float32 operations over the peak rate."""
    t_bytes, t_ops = n_bytes / HBM_BYTES_PER_S, flops / FP32_FLOPS
    return {"bound_ms": max(t_bytes, t_ops) * 1e3,
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "bytes": n_bytes, "flops": flops}


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors
               if t is not None)


def tail_flops(S: int, n_sym: int, M: int, K: int, fft: bool) -> float:
    """Float32 operations of the payload tails: the radix-2 FFT
    (5 M log2 M per row), the S x S complex equalize (8 per complex
    multiply-add, 2 for the gain) and the demap (4 per point)."""
    rows = S * n_sym
    ops = rows * M * (8 * S + 2 + 4 * K)
    if fft:
        ops += rows * 5 * M * np.log2(M)
    return float(ops)


def drive(fn):
    """Run fn() once with every launch count set to 0 just before; return
    its result and the counts read just after."""
    wrappers = launch_counts()
    for w in wrappers.values():
        w.launches = 0
    out = fn()
    torch.cuda.synchronize()
    return out, {name: w.launches for name, w in wrappers.items()}


def graph_launches(launches_by_name: dict) -> dict:
    """Each kernel's launches per call from device_busy's
    ``launches_by_name``: the fewest of its device kernels' (K5 is a scan
    and a resolve), rounded (a profiler session may lose an event or two
    at its edges)."""
    def per_name(name):
        return sum(v for k, v in launches_by_name.items()
                   if k.split("<")[0].split("::")[-1] == name)
    return {k: round(min(per_name(name) for name in names))
            for k, names in DEVICE_KERNELS.items()}


def stacked_shards(cap: torch.Tensor, n_time: int, halo: int):
    """The sharded full-rate stage A's K6 input on one card: shard t's
    left halo (the last ``halo`` samples of shard t - 1, zeros for t = 0)
    then its samples, T zero-padded to n_time * 128 per shard as
    ``parallel.mesh.shard_capture`` pads it; [n_time * S, halo + Tloc],
    shard-major, as ``decode_sharded._sync_stage`` stacks it."""
    S, T = cap.shape
    t_loc = -(-T // (n_time * 128)) * 128
    blocks = torch.nn.functional.pad(cap, (0, n_time * t_loc - T)).view(
        S, n_time, t_loc)
    left = torch.nn.functional.pad(blocks[:, :-1, -halo:], (0, 0, 1, 0))
    rows = torch.cat([left, blocks], dim=-1)  # [S, n_time, halo + Tloc]
    return rows.transpose(0, 1).reshape(n_time * S, halo + t_loc)


def check_metric(x: torch.Tensor, M: int, thr: float, metric=None) -> dict:
    """K6 (or ``metric(x, M)``, a build of it) against its plain version
    on capture x: NaN exactly on the windows of zeros, the tolerance on
    finite samples with real energy, and every above-threshold flip
    within FLIP_BAND of the threshold."""
    from rub_mimo_tpu_torch.kernels import sc_metric as k6
    from rub_mimo_tpu_torch.utils.movsum import moving_sum

    got = (metric or k6.sc_metric_fused)(x, M)
    ref = k6.sc_metric_reference(x, M)
    _, energy = k6.moving_corr_energy(x, M)
    zeros = moving_sum((x != 0).to(torch.int64), M) == 0
    torch.cuda.synchronize()
    require(got.dtype == torch.float32 and got.shape == ref.shape,
            f"K6 output {got.dtype} {tuple(got.shape)}")
    require(torch.equal(torch.isnan(got), zeros),
            "K6 NaN on other samples than the windows of zeros")
    ok = torch.isfinite(ref) & (energy >= ENERGY_FLOOR * energy.median())
    g, r = got[ok], ref[ok]
    err = (g - r).abs()
    use = err / (METRIC_ATOL + METRIC_RTOL * r.abs())
    big = r.abs() >= METRIC_ATOL
    flips = ((got > thr) != (ref > thr))
    flip_dist = (ref[flips] - thr).abs()
    out = {"shape": list(x.shape), "M": M, "checked": int(ok.sum()),
           "zero_windows": int(zeros.sum()),
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
    chunk = k5.chunk_len(cfg.M)
    t_star = int(ref[1])
    out = {"case": name, "T": x.shape[-1], "M": cfg.M,
           "synced": bool(ref[0]), "t_star": t_star,
           "chunk": t_star // chunk, "last_chunk": (x.shape[-1] - 1) // chunk,
           "chunks": k5.sc_sync_fused.chunks,
           "chunks_scanned": int(k5.sc_sync_fused.chunks_scanned),
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


def same_decode(r, ref, table, what: str) -> dict:
    """Decode r against decode ref of the same capture: integer fields
    equal, decisions equal but at near-ties of ref's equalized symbols."""
    for f in INT_FIELDS:
        if f != "rx_data":
            require(torch.equal(getattr(r, f), getattr(ref, f)),
                    f"{what}: {f} differs")
    return compare(None, r.rx_data, ref.rx_sig, ref.rx_data, table)


def check_payload_kernels(dev, cfg) -> dict:
    """K7, K4, K3 and K2 against their plain versions on seeded inputs at
    the operating point's shapes: K7 bit for bit, the others' decisions
    equal but at near-ties, their symbols within SIG_REL_TOL of RMS.
    Returns each kernel's case at the main path's shapes for the times
    and the kernels line."""
    from rub_mimo_tpu_torch import Modulation
    from rub_mimo_tpu_torch.detect import zf
    from rub_mimo_tpu_torch.kernels import cp_strip as k7
    from rub_mimo_tpu_torch.kernels import eq_demap as k34
    from rub_mimo_tpu_torch.kernels import payload_fused as pf
    from rub_mimo_tpu_torch.ofdm import constellation

    S, M, sym, n_sym = 2, cfg.M, cfg.symbol_len, cfg.pid_max
    rng = np.random.default_rng(7)
    out = {}
    for dtype in (torch.complex64, torch.float32):
        w = 2 if dtype == torch.complex64 else 1
        p = torch.as_tensor(rng.standard_normal(
            (S, w * n_sym * sym)).astype(np.float32), device=dev)
        if dtype == torch.complex64:
            p = p.view(torch.complex64)
        got = k7.cp_strip(p, n_sym, sym, cfg.cp_len)
        ref = k7.cp_strip_reference(p, n_sym, sym, cfg.cp_len)
        torch.cuda.synchronize()
        err = float((got - ref).abs().max())
        require(torch.equal(got, ref), f"K7 {dtype} differs from plain")
        emit({"phase": "k7_vs_plain", "dtype": str(dtype),
              "shape": list(p.shape), "bit_equal": True,
              "max_abs_err": err})
        if dtype == torch.complex64:
            out["cp_strip"] = dict(args=(p, n_sym, sym, cfg.cp_len),
                                   max_abs_err=err)

    def symbols(shape, scale=0.8):
        return torch.as_tensor(
            ((rng.standard_normal(shape) + 1j * rng.standard_normal(shape))
             * scale).astype(np.complex64), device=dev)

    for shape, mod in (((S, n_sym, M), Modulation.ARB32OPT),
                       ((S, n_sym, 1638), Modulation.QAM16),
                       ((1, n_sym, 50), Modulation.QAM256)):
        y = symbols(shape)
        tab = constellation.table(mod)
        res = compare(None, k34.demap(y, tab), y,
                      constellation.hard_demap(y, tab), tab)
        emit({"phase": "k4_vs_plain", "shape": list(shape),
              "points": len(tab), **res})

    G = ((rng.standard_normal((M, S, S)) + 1j * rng.standard_normal(
        (M, S, S))) / np.sqrt(2) + 2.0 * np.eye(S)).astype(np.complex64)
    W, gain = zf.invert(torch.as_tensor(G, device=dev))
    tab = constellation.table(Modulation.ARB32OPT)
    norm = np.float32(1.0 / np.sqrt(M))
    x = symbols((S, n_sym, M), 1.0)
    X = x * float(norm)
    res3 = compare(*k34.eq_demap(X, W, gain, tab),
                   *k34.eq_demap_reference(X, W, gain, tab), tab)
    emit({"phase": "k3_vs_plain", "shape": [S, n_sym, M], **res3})
    res2 = compare(*pf.payload_fused(x, W, gain, tab, norm),
                   *pf.payload_fused_reference(x, W, gain, tab, norm), tab)
    emit({"phase": "k2_vs_plain", "shape": [S, n_sym, M], **res2})
    out["eq_demap"] = dict(args=(X, W, gain, tab),
                           max_abs_err=res3["max_abs_err"])
    out["payload_fused"] = dict(args=(x, W, gain, tab, norm),
                                max_abs_err=res2["max_abs_err"])
    return out



def demap_by_modulation(dev, cfg, cases) -> dict:
    """K4 and K3 (up to 64 points) on each modulation, BPSK to QAM256, at
    the operating point's [2, 1000, M]: the symbols are
    eq_demap.probe_symbols (cells of one to four candidates, cell edges,
    ties, outside the grid's box, 0, NaN, Inf), K3's equalized values
    too (X = G y per subcarrier with the K3 case's W gain = G^-1).  Each
    is held against its plain version (decisions equal but at near-ties,
    K3's symbols within SIG_REL_TOL of RMS) and against the kernel's own
    full scan of every point (``demap_full_scan``, equal bit for bit);
    device µs per call of each (torch.profiler, median of 10)."""
    from rub_mimo_tpu_torch import Modulation
    from rub_mimo_tpu_torch.kernels import eq_demap as k34
    from rub_mimo_tpu_torch.ofdm import constellation

    X3, W, gain, _ = cases["eq_demap"]["args"]
    S, n_sym, M = X3.shape
    G = torch.linalg.inv(W * gain[:, None, None])
    out = {}
    for mod in (Modulation.BPSK, Modulation.QPSK, Modulation.QAM16,
                Modulation.ARB32OPT, Modulation.QAM64, Modulation.QAM256):
        tab = constellation.table(mod)
        y = torch.as_tensor(k34.probe_symbols(tab, S * n_sym * M, len(tab)),
                            device=dev).reshape(S, n_sym, M)
        got = k34.demap(y, tab)
        res = {"points": len(tab),
               "k4": compare(None, got, y, constellation.hard_demap(y, tab),
                             tab)}
        require(torch.equal(got, k34.demap_full_scan(y, tab)),
                f"K4 {mod.name}: the region search differs from the full "
                "scan")
        res["k4"].update(
            full_scan_equal=True,
            us=profiled_us(lambda: k34.demap(y, tab)),
            full_scan_us=profiled_us(lambda: k34.demap_full_scan(y, tab)))
        res["k4"].pop("mismatch_margins")
        if len(tab) <= k34.MAX_EQ_POINTS:
            X = torch.einsum("mij,jkm->ikm", G, torch.where(
                torch.isfinite(y), y, 0)).contiguous()
            sig, data = k34.eq_demap(X, W, gain, tab)
            res["k3"] = compare(sig, data,
                                *k34.eq_demap_reference(X, W, gain, tab), tab)
            require(torch.equal(data, k34.demap_full_scan(sig, tab)),
                    f"K3 {mod.name}: the region search differs from the "
                    "full scan")
            res["k3"].update(
                full_scan_equal=True,
                us=profiled_us(lambda: k34.eq_demap(X, W, gain, tab)))
            res["k3"].pop("mismatch_margins")
        out[mod.name] = res
    return out

def check_halos(k8, mesh, parts) -> float:
    """K8 against its plain version on the halos parts[t][s]: equal bit
    for bit.  Returns the largest difference (0.0)."""
    got = k8.ring_shift_right(parts, mesh)
    ref = k8.ring_shift_right_reference(parts, mesh)
    torch.cuda.synchronize()
    sync_all()
    err = 0.0
    for t, row in enumerate(got):
        for s, g in enumerate(row):
            want = ref[t][s].to(g.device)  # across cards: t-1's card
            require(torch.equal(g, want),
                    f"K8 differs from its plain version at shard {(t, s)}")
            err = max(err, float((g - want).abs().max()))
    return err


def sync_all() -> None:
    for i in range(torch.cuda.device_count()):
        torch.cuda.synchronize(i)


def launch_device_us(fn, name: str, n: int = 10, tries: int = 3) -> dict:
    """torch.profiler over n calls of fn: the mean device µs of one
    launch of the kernels whose name holds ``name``, by card index, and
    the launches per call.  A session that recorded none of them is run
    again, up to ``tries`` sessions; empty when none did."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    sync_all()
    ev = []
    for _ in range(tries):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(n):
                fn()
            sync_all()
        ev = [e for e in prof.events() if e.device_type == DeviceType.CUDA
              and name in e.name]
        if ev:
            break
    by_card: dict = {}
    for e in ev:
        by_card.setdefault(e.device_index, []).append(
            e.time_range.elapsed_us())
    return {"us_by_card": {str(c): statistics.mean(v)
                           for c, v in sorted(by_card.items())},
            "launches_per_call": len(ev) / n}


def stream_ser(rx_data: torch.Tensor, tx_data, cfg) -> list:
    """SER % of each rx stream s against tx stream s (RX_ZF scoring)."""
    n = cfg.pid_max * cfg.M_occupied
    got, tx = rx_data.cpu().numpy(), np.asarray(tx_data)
    return [float((got[s, :n] != tx[s, :n]).mean() * 100.0)
            for s in range(cfg.num_streams)]


def same_sharded(got, ref, table, what: str) -> dict:
    """A sharded decode against the single-device decode of the same
    capture: synced, sync_index, sync_sample and decode_start equal, G
    within SHARDED_G_RTOL / SHARDED_G_ATOL, decisions equal but at
    near-ties of the single decode's symbols."""
    torch.cuda.synchronize()
    for f in ("synced", "sync_index", "sync_sample", "decode_start"):
        require(int(getattr(got, f)) == int(getattr(ref, f)),
                f"{what}: {f} {int(getattr(got, f))} vs "
                f"{int(getattr(ref, f))}")
    g_err = (got.G - ref.G).abs()
    require(bool((g_err <= SHARDED_G_ATOL
                  + SHARDED_G_RTOL * ref.G.abs()).all()),
            f"{what}: G outside rtol {SHARDED_G_RTOL} atol {SHARDED_G_ATOL}")
    out = compare(None, got.rx_data, ref.rx_sig, ref.rx_data, table)
    out["G_max_abs_err"] = float(g_err.max())
    return out


def run_path(name: str, dec, planes, tx_data, cfg, expect: dict,
             ser_zero: bool = True):
    """Decode once with the counts at 0, check the payload kernels'
    launches against ``expect`` (kernels not named: 0) and the SER."""
    from rub_mimo_tpu_torch.pipeline import report

    r, counts = drive(lambda: dec(*planes))
    got = {k: counts[k] for k in PAYLOAD_KERNELS}
    want = {k: expect.get(k, 0) for k in PAYLOAD_KERNELS}
    require(got == want, f"{name}: launches {got}, expected {want}")
    rep = report.score(r, tx_data, cfg)
    require(rep.synced, f"{name}: did not sync")
    if ser_zero:
        require(all(s == 0.0 for s in rep.symbol_error_rate),
                f"{name}: SER {rep.symbol_error_rate}")
    emit({"phase": "path", "path": name, "capture": list(planes[0].shape),
          "m_occupied": cfg.M_occupied, "launches": counts,
          "ser_percent": rep.symbol_error_rate,
          "evm_percent": rep.evm_percent})
    return r, counts


def across_cards(cfg, cap, tx_data, r, qcfg, qcap, qtx, rq):
    """The across_cards phase, on 2 or more cards (else it prints
    ``run: false``): K8 pulling halos across cards bit for bit against
    its plain version; the operating point's sharded decode across the
    cards ((2, 1) on two, (4, 1) and (2, 2) on four, ``pallas_dma``, and
    ``ppermute`` on (n, 1) beside it) and, on four, mimo_4x4_wideband
    (4, 1) with ``pallas_dma``, each held equal to the single decode (r,
    rq) with SER 0 and its launch counts asserted; batched serving of
    8 captures (SERVING_SEEDS) over the cards and over one card, each
    capture against its single decode.  Returns what phases 10 and 12
    time, or None."""
    from rub_mimo_tpu_torch.io import simulator
    from rub_mimo_tpu_torch.kernels import halo_dma as k8
    from rub_mimo_tpu_torch.ofdm import constellation
    from rub_mimo_tpu_torch.parallel import decode_sharded as ds
    from rub_mimo_tpu_torch.parallel import mesh as pmesh
    from rub_mimo_tpu_torch.parallel import serving
    from rub_mimo_tpu_torch.pipeline import rx

    cards = torch.cuda.device_count()
    if cards < 2:
        emit({"phase": "across_cards", "run": False, "cards": cards})
        return None
    n_time = 4 if cards >= 4 else 2
    devs = [torch.device("cuda", i) for i in range(n_time)]
    home = devs[0]
    S, halo = cfg.num_streams, cfg.M - 1

    # K8 on seeded random halos of meshes whose shards cycle over the
    # cards (one launch per card), then on the operating point's halos
    rng = np.random.default_rng(9)
    for shape in ((2, 1), (4, 1), (4, 2)):
        flat = [devs[i % n_time] for i in range(shape[0] * shape[1])]
        hmesh = pmesh.make_mesh(*shape, devices=flat)
        parts = [[torch.as_tensor(
            (rng.standard_normal((S, halo)) + 1j * rng.standard_normal(
                (S, halo))).astype(np.complex64), device=hmesh.devices[t, s])
            for s in range(shape[1])] for t in range(shape[0])]
        err, c = drive(lambda: check_halos(k8, hmesh, parts))
        require(c["ring_shift_right"] == len(set(flat)),
                f"K8 across cards on {shape}: {c['ring_shift_right']} "
                f"launches, expected {len(set(flat))}")
        emit({"phase": "across_cards", "case": "k8_random",
              "mesh": list(shape), "cards": [d.index for d in flat],
              "halo": [S, halo], "launches": c["ring_shift_right"],
              "bit_equal": True, "max_abs_err": err})
    mesh_x = pmesh.make_mesh(n_time, 1, devices=devs)
    op_halos = [[b[:, -halo:] for b in row]
                for row in pmesh.shard_capture(cap, mesh_x)]
    k8_err, c = drive(lambda: check_halos(k8, mesh_x, op_halos))
    require(c["ring_shift_right"] == n_time,
            f"K8 across cards: {c['ring_shift_right']} launches")
    emit({"phase": "across_cards", "case": "k8_operating_point",
          "mesh": [n_time, 1], "halo": [S, halo], "launches": n_time,
          "bit_equal": True, "max_abs_err": k8_err})

    # the sharded decodes; launches: K1 on every shard, K8 and K6 once per
    # card of the "sc" column 0 with pallas_dma, none with ppermute (the
    # coarse stage A)
    paths = {f"pallas_dma_{n_time}x1": (cfg, "pallas_dma", (n_time, 1)),
             f"ppermute_{n_time}x1": (cfg, "ppermute", (n_time, 1))}
    if cards >= 4:
        paths["pallas_dma_2x2"] = (cfg, "pallas_dma", (2, 2))
        paths["mimo_4x4_wideband_pallas_dma_4x1"] = (qcfg, "pallas_dma",
                                                     (4, 1))
    runs = {}
    for name, (c_cfg, impl, shape) in paths.items():
        smesh = pmesh.make_mesh(*shape, devices=[
            torch.device("cuda", i) for i in range(shape[0] * shape[1])])
        capture, ref, txd = ((qcap, rq, qtx) if c_cfg is qcfg
                             else (cap, r, tx_data))
        planes_sh = pmesh.shard_capture_planes(capture, smesh)
        d = ds.build_sharded_decoder(
            c_cfg, smesh, shape[0] * planes_sh[0][0][0].shape[1],
            halo_impl=impl, input_format="planes")
        rs, counts = drive(lambda: d(*planes_sh))
        sync_all()
        col = len(set(smesh.devices[:, 0])) if impl == "pallas_dma" else 0
        want = {k: 0 for k in KERNELS}
        want.update(payload_fused_strip=shape[0] * shape[1],
                    ring_shift_right=col, sc_metric=col)
        require(counts == want, f"across cards {name}: launches {counts}, "
                f"expected {want}")
        require(rs.G.device == home and rs.rx_data.device == home,
                f"across cards {name}: results not on {home}")
        scmp = same_sharded(rs, ref, constellation.table(c_cfg.modulation),
                            f"across cards {name}")
        ser = stream_ser(rs.rx_data, txd, c_cfg)
        require(all(x == 0.0 for x in ser), f"across cards {name}: SER {ser}")
        emit({"phase": "across_cards", "path": name, "mesh": list(shape),
              "cards": [x.index for x in smesh.devices.flat],
              "halo_impl": impl, "capture": list(capture.shape),
              "shard": list(planes_sh[0][0][0].shape), "launches": counts,
              "ser_percent": ser, "equal_to_single_device": True, **scmp})
        runs[name] = (d, planes_sh)
        del rs

    # batched serving: the SERVING_SEEDS captures over the cards, and the
    # same captures over one card, each against its single decode
    caps, txs = [], []
    for seed in SERVING_SEEDS:
        spec = simulator.ChannelSpec(snr_db=30.0, delay=5000, seed=seed)
        c8, t8, _ = simulator.simulate_capture(cfg, spec, device=home)
        caps.append(c8)
        txs.append(t8)
    t_min = min(x.shape[-1] for x in caps)
    batch = torch.stack([x[:, :t_min] for x in caps])
    del caps
    single = rx.make_decoder(cfg, device=home)
    n_serve = len(SERVING_SEEDS)
    refs = [single(batch[i]) for i in range(n_serve)]
    tab = constellation.table(cfg.modulation)
    serve = {}
    for key, sdevs in (("cards", devs), ("one_card", [home] * n_time)):
        smesh = pmesh.make_mesh(n_time, 1, devices=sdevs)
        sdec = serving.make_sharded_batch_decoder(cfg, smesh)
        blocks = serving.shard_batch(batch, smesh)
        got, counts = drive(lambda: sdec(blocks))
        sync_all()
        require(counts["payload_fused_strip"] == n_serve,
                f"serving on {key}: launches {counts}")
        require(got.rx_data.device == home, f"serving on {key}: not on home")
        worst = {"mismatches": 0, "G_max_abs_err": 0.0}
        for i in range(n_serve):
            gi = rx.DecodeResult(*(None if x is None else x[i] for x in got))
            ci = same_sharded(gi, refs[i], tab, f"serving on {key}, {i}")
            ser = stream_ser(gi.rx_data, txs[i], cfg)
            require(all(x == 0.0 for x in ser),
                    f"serving on {key}, capture {i}: SER {ser}")
            worst["mismatches"] += ci["mismatches"]
            worst["G_max_abs_err"] = max(worst["G_max_abs_err"],
                                         ci["G_max_abs_err"])
        emit({"phase": "across_cards", "path": f"serving_{key}",
              "mesh": [n_time, 1], "cards": [x.index for x in sdevs],
              "batch": list(batch.shape), "launches": counts,
              "equal_to_single_decodes": True, "ser_zero": True, **worst})
        serve[key] = (sdec, blocks)
    return {"cards": cards, "n_time": n_time, "runs": runs, "serve": serve,
            "k8": (mesh_x, op_halos)}


def serve_path(name: str, cfg, planes, txs, kw: dict, expect: dict,
               eager: dict, iters: int = MODE_ITERS) -> dict:
    """Serve the [B, S, T] planes stacks through
    ``make_serving_decoder(cfg, input_format="planes", **kw)``: one CUDA
    graph of the decode, replayed per capture.  The first call (its two
    warm-up decodes and the capture) runs with every launch count at 0;
    one replay's kernels, counted by name with torch.profiler, must be
    at least one launch of each kernel in ``expect`` (kernel -> launches a
    decode makes), and none of the others.  Each capture is held against the
    eager decode with the same options: integer fields equal, G within
    rtol 1e-4 / atol 1e-6, SER 0 on every stream.  Times (CUDA events,
    medians of ``iters``): the served batch per capture (input copy,
    replay, output copies), the replay alone, and each ``eager`` decoder
    (label -> planes decoder) on capture 0; the device's busy time and
    idle share of one replay."""
    from rub_mimo_tpu_torch.pipeline import rx

    serve = rx.make_serving_decoder(cfg, device="cuda",
                                    input_format="planes", **kw)
    got, counts = drive(lambda: serve(*planes))
    require(all(counts[k] >= 1 for k in expect),
            f"serving {name}: the captured decode launched {counts}")
    same = rx.make_decoder(cfg, device="cuda", input_format="planes", **kw)
    B = planes[0].shape[0]
    ser = []
    for i in range(B):
        ref = same(planes[0][i], planes[1][i])
        for f in INT_FIELDS:
            require(torch.equal(getattr(got, f)[i], getattr(ref, f)),
                    f"serving {name}: capture {i}'s {f} differs from the "
                    "eager decode")
        np.testing.assert_allclose(got.G[i].cpu().numpy(),
                                   ref.G.cpu().numpy(), rtol=1e-4, atol=1e-6)
        ser.append(stream_ser(got.rx_data[i], txs[i], cfg))
        require(all(x == 0.0 for x in ser[-1]),
                f"serving {name}: capture {i} SER {ser[-1]}")
    graph = serve.graphs[tuple(planes[0].shape[1:])]
    t_served = cuda_ms(lambda: serve(*planes), iters=iters)
    t_replay = cuda_ms(graph.graph.replay, iters=iters)
    busy = device_busy(graph.graph.replay)
    in_graph = graph_launches(busy["launches_by_name"])
    require(all((in_graph[k] >= 1) == (k in expect) for k in KERNELS),
            f"serving {name}: one replay launched {in_graph}, expected "
            f"{expect}")
    t_eager = {label: cuda_ms(lambda d=d: d(planes[0][0], planes[1][0]),
                              iters=iters) for label, d in eager.items()}
    per_capture = t_served["median_ms"] / B
    busy_ms = busy["busy_ms_median"] or busy["busy_ms"]
    out = {"phase": "serving", "path": name, "card": card_line(),
           "batch": B, "capture": list(planes[0].shape[1:]),
           "options": kw, "launches_first_call": counts,
           "launches_per_replay": in_graph,
           "launches_per_decode_eager": expect,
           "kernels_per_replay": busy["kernels"],
           "kernels_per_replay_by_name": busy["launches_by_name"],
           "longest_kernels_us": busy["top_kernels_us"],
           "ser_percent": ser, "int_fields_equal_eager": True,
           "served_ms_per_capture": per_capture,
           "served_batch_ms": t_served, "replay_ms": t_replay,
           "device_busy_ms_per_replay": busy_ms,
           "device_idle_share_replay": (
               None if busy_ms is None
               else 1.0 - busy_ms / t_replay["median_ms"]),
           "device_idle_share_served": (
               None if busy_ms is None else 1.0 - busy_ms / per_capture),
           "eager_ms": t_eager}
    emit(out)
    del serve, graph, got
    torch.cuda.empty_cache()
    return out


def no_host_sync(paths: dict) -> dict:
    """One eager decode of each path (label -> (planes decoder, planes))
    under torch.cuda.set_sync_debug_mode("error"), after a warm-up
    decode, with the mode shown to raise on a host read first."""
    out = {}
    for label, (dec, planes) in paths.items():
        dec(*planes)
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            try:
                int(planes[0].sum())
                raised = False
            except RuntimeError:
                raised = True
            require(raised, "set_sync_debug_mode('error') let a read pass")
            r = dec(*planes)
        finally:
            torch.cuda.set_sync_debug_mode(0)
        require(bool(r.synced), f"no_host_sync {label}: did not sync")
        out[label] = "no synchronizing call"
    emit({"phase": "no_host_sync", "mode": "error", "decodes": out})
    return out


def two_bursts(cfg, dev, spec):
    """A full-width capture with two bursts of cfg's frame, the second a
    replay window and three symbols after the first's start (as
    tests/test_multiburst.py builds them): (capture, tx data of each)."""
    from rub_mimo_tpu_torch.io import simulator
    from rub_mimo_tpu_torch.ofdm import framegen

    h = simulator.draw_channel(spec, cfg.num_streams, cfg.num_streams)
    data = [framegen.generate_payload_symbols(cfg, seed=k) for k in (1, 2)]
    tx = [framegen.transmit_frame(cfg, d, device=dev) for d in data]
    gap = cfg.window_len + 3 * cfg.symbol_len
    S = cfg.num_streams
    z = [torch.zeros((S, n), dtype=torch.complex64, device=dev) for n in
         (300, max(gap - tx[0].shape[-1], 64), 500)]
    cap = simulator.apply_channel(torch.cat([z[0], tx[0], z[1], tx[1], z[2]],
                                            dim=-1), h, spec, cfg)
    return cap, data


STREAM_CHUNKS = (65536, 4096)  # the module's default chunk, cli listen's
STREAM_BLOCK = 8               # chunks a push_block call
NOISE_CHUNKS = 64              # chunks of seeded noise the seek check takes
SPAN_RUNS = 5                  # timed payload phases a streamed path


def feed(dec, x: torch.Tensor, block: int = 1, sync_each: bool = False):
    """Push x [S, T] through a StreamingDecoder, zero-padded to whole
    calls of ``block`` chunks (push for 1, else push_block), then
    finalize.  Returns one record a call: (phase before, phase after,
    bursts completed in it, its host reads, its wall ms; with sync_each
    the device's work for the call is inside the ms)."""
    n = block * dec.C
    calls = -(-x.shape[-1] // n)
    x = torch.nn.functional.pad(x, (0, calls * n - x.shape[-1]))
    recs = []
    for i in range(calls):
        piece = x[:, i * n:(i + 1) * n]
        before, reads, done = dec.phase, dec.host_reads, len(dec.bursts)
        t0 = time.perf_counter()
        if block == 1:
            dec.push(piece)
        else:
            dec.push_block(piece)
        if sync_each:
            torch.cuda.synchronize()
        recs.append((before, dec.phase, len(dec.bursts) - done,
                     dec.host_reads - reads,
                     (time.perf_counter() - t0) * 1e3))
    dec.finalize()
    return recs


def payload_span(dec, x: torch.Tensor, strict: bool = False):
    """Push x [S, T] chunk by chunk into the fresh StreamingDecoder dec
    until it reaches the payload phase, then time, on the wall clock
    synchronized at both ends, the pushes that stay in the payload phase
    and complete no burst.  With strict they run under
    torch.cuda.set_sync_debug_mode("error"), shown to raise on a host
    read first.  Returns (pushes, seconds)."""
    C = dec.C
    n = -(-x.shape[-1] // C)
    x = torch.nn.functional.pad(x, (0, n * C - x.shape[-1]))
    i = 0
    while dec.phase != "payload":
        dec.push(x[:, i * C:(i + 1) * C])
        i += 1
    torch.cuda.synchronize()
    pushes = 0
    if strict:
        torch.cuda.set_sync_debug_mode("error")
    try:
        if strict:
            try:
                int(x[0, 0].real)
                raised = False
            except RuntimeError:
                raised = True
            require(raised, "set_sync_debug_mode('error') let a read pass")
        t0 = time.perf_counter()
        while i < n and dec.gpos + 2 * C < dec._burst_end:
            dec.push(x[:, i * C:(i + 1) * C])
            i += 1
            pushes += 1
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    return pushes, time.perf_counter() - t0


def stream_stats(make, T: int, span=None) -> dict:
    """Throughput and per-call costs of one streamed path: ``make()``
    builds a StreamingDecoder and streams a T-sample capture through it
    (``feed``), returning (decoder, records); ``span()`` times its
    payload phase (``payload_span``).  The whole stream's wall time (a
    second, warm run, synchronized at its end), the payload phase's (ms
    a push, median and least of SPAN_RUNS runs), the per-call records
    of a run synchronized after every call (host reads by phase; latency
    medians, the sync included), and the device's busy time and kernels
    over one stream (torch.profiler)."""
    make()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    dec, _ = make()
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    out = {"chunk": dec.C, "samples": T, "wall_ms": wall_s * 1e3,
           "samples_per_s": T / wall_s}
    if span is not None:
        span()
        runs = [span() for _ in range(SPAN_RUNS)]
        pushes = runs[0][0]
        ms = sorted(secs / n * 1e3 for n, secs in runs)
        out.update(payload_pushes_timed=pushes,
                   payload_push_ms=statistics.median(ms),
                   payload_push_ms_min=ms[0],
                   payload_samples_per_s=dec.C / statistics.median(ms) * 1e3)
    _, recs = make(sync_each=True)
    calls = len(recs)
    latency: dict = {}
    reads: dict = {}
    for before, after, done, n_reads, ms in recs:
        key = before if before == after and not done else "transition"
        reads.setdefault(key, []).append(n_reads)
        latency.setdefault(key, []).append(ms)
    busy = device_busy(make, n=1)
    busy_ms = busy["busy_ms"]
    out.update(
        calls=calls,
        call_latency_ms_median={k: statistics.median(v)
                                for k, v in sorted(latency.items())},
        host_reads_per_call={k: {"calls": len(v), "max": max(v),
                                 "mean": sum(v) / len(v)}
                             for k, v in sorted(reads.items())},
        host_reads_total=dec.host_reads,
        device_busy_ms=busy_ms,
        idle_share=(None if busy_ms is None
                    else 1.0 - busy_ms / (wall_s * 1e3)),
        kernels_per_call={k: v / calls for k, v in
                          busy["launches_by_name"].items()},
        kernels_us=busy["kernels_us"])
    return out


def streaming_phase(dev, card, cfg, cap, tx_data, r, cfg_cfo, cap_c, tx_c,
                    rc, p_re, p_im) -> dict:
    """The streaming decoder (pipeline.streaming) at full width: the
    operating point streamed through decode_stream at each of
    STREAM_CHUNKS and through push_block, each equal to the eager decode
    r; the CFO config and track_channel (8-frame groups) streamed; the
    two-burst capture against decode_all; a seek over seeded noise;
    the payload phase under set_sync_debug_mode("error"); and K6 and K1
    at the shapes the stream gives them against their plain versions.
    Returns each kernel's launches per streamed capture, by path."""
    from rub_mimo_tpu_torch.io import simulator
    from rub_mimo_tpu_torch.kernels import payload_fused as pf
    from rub_mimo_tpu_torch.ofdm import constellation
    from rub_mimo_tpu_torch.pipeline import rx
    from rub_mimo_tpu_torch.pipeline import streaming

    tab = constellation.table(cfg.modulation)
    T, M, sym = cap.shape[-1], cfg.M, cfg.symbol_len
    launches: dict = {}

    def count(path: str, counts: dict) -> None:
        for k in ("payload_fused_strip", "demap", "sc_metric", "cp_strip"):
            if counts[k]:
                launches.setdefault(k, {})[path] = counts[k]

    def streamer(c, x, C, block=1):
        def make(sync_each=False):
            dec = streaming.StreamingDecoder(c, device=dev, chunk_size=C)
            return dec, feed(dec, x, block, sync_each)
        return make

    # K6 and K1 at the streamed shapes against their plain versions: a
    # seek chunk's [tail, chunk] over the frame's plateau, and K1 on
    # runs of 30, 2 and 1 frames at the symbol pitch
    t0 = int(r.sync_index) - 3000
    shapes = {"k6": {}, "k1": {}}
    for C in STREAM_CHUNKS:
        shapes["k6"][str(C)] = check_metric(
            cap[:, t0:t0 + C + M - 1].contiguous(), M, cfg.plateau_threshold)
    norm = np.float32(1.0 / np.sqrt(cfg.M_occupied))
    for n in (30, 2, 1):
        kw = dict(n_sym=n, symbol_len=sym, cp_len=cfg.cp_len)
        args = (p_re[:, :n * sym].contiguous(), p_im[:, :n * sym].contiguous(),
                r.W, r.normalize_gain, tab, norm)
        shapes["k1"][str(n)] = compare(
            *pf.payload_fused_strip(*args, **kw),
            *pf.payload_tail_reference(*args, **kw), tab)
    emit({"phase": "streaming_kernel_shapes", **shapes})

    # the operating point: decode_stream at each chunk, push_block at
    # the default chunk; each equal to the eager decode
    paths = {f"decode_stream_{C}": (
        lambda C=C: streaming.decode_stream(cap, cfg, C, device=dev), C, 1)
        for C in STREAM_CHUNKS}
    C0 = STREAM_CHUNKS[0]
    paths[f"push_block_{STREAM_BLOCK}x{C0}"] = (
        lambda: streamer(cfg, cap, C0, STREAM_BLOCK)()[0], C0, STREAM_BLOCK)
    results = {}
    for name, (run, C, block) in paths.items():
        def whole(run=run):
            dec = run()
            dec.finalize()
            return dec, dec.result()
        (dec, (rx_sig, rx_data)), counts = drive(whole)
        count(name, counts)
        require(dec.synced and dec.sync_index == int(r.sync_index),
                f"{name}: sync_index {dec.sync_index} vs {int(r.sync_index)}")
        want_start = int(r.sync_index) - sym + int(r.decode_start)
        require(dec.decode_start == want_start,
                f"{name}: decode_start {dec.decode_start} vs {want_start}")
        cmp = compare(rx_sig, rx_data, r.rx_sig, r.rx_data, tab)
        ser = stream_ser(rx_data, tx_data, cfg)
        require(all(x == 0.0 for x in ser), f"{name}: SER {ser}")
        require(counts["sc_metric"] >= 1 and counts["payload_fused_strip"]
                >= 1 and counts["demap"] >= 1, f"{name}: launches {counts}")
        stats = stream_stats(streamer(cfg, cap, C, block), T, span=lambda C=C:
                             payload_span(streaming.StreamingDecoder(
                                 cfg, device=dev, chunk_size=C), cap))
        results[name] = {"launches": counts, "sync_index": dec.sync_index,
                         "decode_start": dec.decode_start,
                         "bursts": len(dec.bursts), "ser_percent": ser,
                         **cmp, **stats}
        emit({"phase": "streaming", "path": name, "card": card,
              **results[name]})

    # the CFO config (coarse CFO at the fire, S0 fallback armed, the
    # residual at estimation) and track_channel in 8-frame groups.  The
    # streamed tracker (the JAX package's streaming semantics, which
    # tests/test_torch_streaming.py holds the port to) refits within each
    # payload block, so a block's last group can hold one or two frames,
    # whose refit is rank deficient and errs where the offline tracker
    # does not.  So the streamed track_channel is held against the port's
    # streamed decode on the CPU (the plain versions), and its SER and
    # first erring frame are printed.
    tcfg = cfg.replace(track_channel=True, track_block_frames=8)
    for name, c, x, txd, ref in (("cfo_config", cfg_cfo, cap_c, tx_c, rc),
                                 ("track_channel", tcfg, cap, tx_data, None)):
        def whole(c=c, x=x):
            dec = streaming.decode_stream(x, c, C0, device=dev)
            dec.finalize()
            return dec, dec.result()
        (dec, (sig, rx_data)), counts = drive(whole)
        count(name, counts)
        ser = stream_ser(rx_data, txd, c)
        require(dec.synced, f"streamed {name} did not sync")
        out = {"launches": counts, "sync_index": dec.sync_index,
               "cfo_hat": dec.cfo_hat, "ser_percent": ser}
        if ref is not None:
            require(all(v == 0.0 for v in ser), f"streamed {name}: SER {ser}")
            out["eager_cfo_hat"] = float(ref.cfo_hat)
            require(abs(dec.cfo_hat - float(ref.cfo_hat)) < 1e-3,
                    f"streamed cfo_hat {dec.cfo_hat} vs {float(ref.cfo_hat)}")
        else:
            require(counts["cp_strip"] >= 1 and counts["demap"] >= 1,
                    f"streamed track_channel launches {counts}")
            cpu = streaming.decode_stream(x.cpu(), c, C0, device="cpu")
            cpu.finalize()
            c_sig, c_data = (t.to(dev) for t in cpu.result())
            require((cpu.sync_index, cpu.decode_start)
                    == (dec.sync_index, dec.decode_start),
                    "streamed track_channel: card and CPU sync differ")
            wrong = (rx_data.cpu().numpy().reshape(c.num_streams, c.pid_max, -1)
                     != np.asarray(txd).reshape(c.num_streams, c.pid_max,
                                                -1)).any(axis=(0, 2))
            out.update(ser_percent_cpu=stream_ser(c_data, txd, c),
                       first_error_frame=(int(np.argmax(wrong)) if wrong.any()
                                          else None),
                       frames_with_errors=int(wrong.sum()),
                       **compare(sig, rx_data, c_sig, c_data, tab,
                                 TRACKED_SIG_REL_TOL))
        out.update(stream_stats(
            streamer(c, x, C0), x.shape[-1], span=lambda c=c, x=x:
            payload_span(streaming.StreamingDecoder(c, device=dev,
                                                    chunk_size=C0), x)))
        emit({"phase": "streaming", "path": name, "card": card, **out})
        results[name] = out

    # two bursts against decode_all
    cap2, data2 = two_bursts(cfg, dev, simulator.ChannelSpec(
        snr_db=35.0, delay=0, trailing=0, seed=5))
    ref2 = rx.decode_all(cap2, cfg, device=dev, max_bursts=4)

    def whole2():
        dec = streaming.decode_stream(cap2, cfg, C0, device=dev)
        dec.finalize()
        return dec.burst_results()
    got, counts = drive(whole2)
    count("two_bursts", counts)
    require(len(got) == len(ref2) == 2,
            f"streamed bursts {len(got)}, decode_all {len(ref2)}")
    burst_out = []
    for (si, sig, data), b, d in zip(got, ref2, data2):
        require(si == int(b.sync_index),
                f"burst sync_index {si} vs decode_all {int(b.sync_index)}")
        ser = stream_ser(data, d, cfg)
        require(all(x == 0.0 for x in ser), f"streamed burst SER {ser}")
        burst_out.append({"sync_index": si, "ser_percent": ser,
                          **compare(sig, data, b.rx_sig, b.rx_data, tab)})
    emit({"phase": "streaming", "path": "two_bursts", "card": card,
          "capture": list(cap2.shape), "launches": counts,
          "bursts": burst_out})
    del cap2, ref2

    # a seek over seeded noise: push_block, one read a block, no fire
    gen = torch.Generator(device=dev).manual_seed(9)
    noise = torch.randn((cfg.num_streams, NOISE_CHUNKS * C0),
                        dtype=torch.complex64, device=dev, generator=gen)
    dec = streaming.StreamingDecoder(cfg, device=dev, chunk_size=C0)
    recs = feed(dec, noise, STREAM_BLOCK)
    t_noise = stream_stats(streamer(cfg, noise, C0, STREAM_BLOCK),
                           noise.shape[-1])
    require(dec.phase == "seek" and not dec.synced,
            "the seek over noise fired")
    require(all(rec[3] == 1 for rec in recs),
            f"push_block over noise read {[rec[3] for rec in recs]}")
    emit({"phase": "streaming", "path": "seek_noise", "card": card,
          "blocks": len(recs), "reads_per_block": 1, **t_noise})
    del noise

    # the payload phase reads nothing back: pushes that stay in it run
    # under set_sync_debug_mode("error")
    checked, _ = payload_span(streaming.StreamingDecoder(
        cfg, device=dev, chunk_size=C0), cap, strict=True)
    require(checked >= 3, f"only {checked} payload pushes checked")
    emit({"phase": "streaming_no_host_sync", "mode": "error",
          "payload_pushes": checked, "chunk": C0})
    return {"launches": launches, "paths": results}


CODED_RATES = ("1/2", "2/3", "3/4")
CODED_ITERS = 10      # timing runs of each coded back-end stage
# float32 operations per state and step of the Viterbi recursion: the
# branch metric's add (shared four ways, counted once), the candidate
# add, the compare, the select, the max and the renormalising subtract
VITERBI_OPS = 6
SFO_PPMS = (20.0, 100.0)  # tests/test_sfo.py's full-geometry case


def ber_by_lane(bits: torch.Tensor, msg: np.ndarray) -> list:
    return [float(v) for v in (bits.cpu().numpy() != msg).mean(axis=-1)]


def stage_busy(fn, iters: int = CODED_ITERS) -> dict:
    """CUDA-event median of fn (ms), the device's busy ms per call from
    torch.profiler (the median over ``iters`` profiled calls where the
    session's events split into the calls, else their mean) and the idle
    share they give."""
    t = cuda_ms(fn, iters=iters, warmup=2)
    prof = device_busy(fn, n=iters)
    busy = prof["busy_ms_median"] or prof["busy_ms"]
    return {"event_ms": t["median_ms"], "wall_ms": t["wall_median_ms"],
            "busy_ms": busy,
            "idle_share": None if busy is None else 1.0 - busy
            / t["median_ms"]}


def coded_phase(dev, card, cfg) -> dict:
    """The coded chain at the operating point: encode_payload(seed=42) at
    each rate, the port's TX and channel, the default planes decode (K1)
    and decode_payload (the soft-LLR rows kernel and the Viterbi kernel),
    BER 0 on both lanes; at rate 1/2 the back end's kernels a call by
    name (the rows kernel, the Viterbi, at most one copy of the decoded
    bits);
    the back end's stages timed, the parent's three beside the rows
    kernel; encode_data / decode_data of a full payload of seeded bytes;
    decode_payload_ml on the ML QPSK config; soft_demodulate_llr.  Returns
    the main path's counts, soft_demodulate_llr's, the decode's rx_sig
    and the Viterbi kernel's rows for the kernel checks."""
    from rub_mimo_tpu_torch import Detector, ModemConfig, Modulation
    from rub_mimo_tpu_torch.io import simulator
    from rub_mimo_tpu_torch.kernels import soft_llr as ks
    from rub_mimo_tpu_torch.kernels import viterbi as kv
    from rub_mimo_tpu_torch.ofdm import constellation, fec
    from rub_mimo_tpu_torch.pipeline import rx

    spec = simulator.ChannelSpec(snr_db=30.0, delay=5000, seed=42)

    def planes_of(c, txd):
        cap, _, _ = simulator.simulate_capture(c, spec, tx_data=txd,
                                               device=dev)
        return cap.real.contiguous(), cap.imag.contiguous()

    dec = rx.make_decoder(cfg, device=dev, input_format="planes")
    main_counts, r_half, msg_half = None, None, None
    for rate in CODED_RATES:
        t0 = time.perf_counter()
        msg, txd = fec.encode_payload(cfg, seed=42, rate=rate)
        encode_s = time.perf_counter() - t0
        planes = planes_of(cfg, txd)

        def path(planes=planes, rate=rate):
            r = dec(*planes)
            return r, fec.decode_payload(r.rx_sig, cfg, rate=rate)

        (r, bits), counts = drive(path)
        ber = ber_by_lane(bits, msg)
        ser = float((r.rx_data.cpu().numpy() != txd).mean())
        emit({"phase": "coded", "rate": rate, "card": card,
              "msg_bits": list(msg.shape), "ber": ber, "ser_uncoded": ser,
              "launches": {k: v for k, v in counts.items() if v},
              "encode_payload_host_s": encode_s})
        require(counts["payload_fused_strip"] == 1
                and counts["soft_llr_rows"] == 1 and counts["viterbi"] == 1
                and counts["soft_llr"] == 0,
                f"coded {rate}: launches {counts}")
        require(all(b == 0.0 for b in ber), f"coded {rate}: BER {ber}")
        if rate == "1/2":
            main_counts, r_half, msg_half = counts, r, msg
        del planes

    # the back end at rate 1/2 on the decode's rx_sig: its kernels a call
    # by name (torch.profiler; rounded, as graph_launches rounds, since a
    # profile may lose an event or two at its edges), the only ones: the
    # rows kernel, the Viterbi, and at most one elementwise copy of the
    # decoded bits (the windows' interiors, which reads the Viterbi's
    # output); no index, gather, pad or fill kernel, so none reads or
    # writes the LLRs but the first two
    sig = r_half.rx_sig
    by_name = {k: round(v) for k, v in device_busy(
        lambda: fec.decode_payload(sig, cfg), n=5)[
            "launches_by_name"].items()}
    ours = {k: v for k, v in by_name.items()
            if k.split("<")[0] in ("soft_llr_rows_kernel", "viterbi_kernel")}
    others = {k: v for k, v in by_name.items() if k not in ours}
    emit({"phase": "coded_kernels", "card": card, "rate": "1/2",
          "launches_by_name": by_name})
    require(sorted((k.split("<")[0], v) for k, v in ours.items())
            == [("soft_llr_rows_kernel", 1), ("viterbi_kernel", 1)]
            and sum(others.values()) <= 1
            and all("elementwise" in k for k in others),
            f"coded 1/2: the back end's kernels {by_name}")

    # the back end's stages at rate 1/2: the parent's three (the LLRs, the
    # deinterleave and depuncture gathers, viterbi_rows' pads and window
    # copies), then the rows kernel and the Viterbi on its rows
    n_msg = fec.message_bits_per_stream(cfg)
    used = 2 * (n_msg + fec.TAIL)
    S = cfg.num_streams
    tab = constellation.table(cfg.modulation)
    plan = fec.row_plan(sig.shape[1] * cfg.modulation.bits_per_symbol, cfg)

    def llrs():
        return constellation.soft_demodulate_llr(sig, cfg.modulation, 1.0)

    lv = llrs().reshape(S, -1)

    def deinterleave():
        x = fec.deinterleave(lv, fec.INTERLEAVE_SPREAD)
        return fec.depuncture_llrs(x[:, :fec._kept_bits(used, "1/2")], used,
                                   "1/2")

    dep = deinterleave()
    rows = ks.soft_llr_rows(sig, plan, tab, 1.0)

    def old_chain():
        x = fec.deinterleave(llrs().reshape(S, -1), fec.INTERLEAVE_SPREAD)
        return fec.viterbi_decode(fec.depuncture_llrs(
            x[:, :fec._kept_bits(used, "1/2")], used, "1/2"), window=4096)

    peak = {}
    for name, fn in (("back_end", lambda: fec.decode_payload(sig, cfg)),
                     ("parent_chain", old_chain)):
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        fn()
        torch.cuda.synchronize()
        peak[name] = torch.cuda.max_memory_allocated() - base
    require(torch.equal(old_chain(), fec.decode_payload(sig, cfg)),
            "coded 1/2: the back end differs from the parent's chain")
    stages = {
        "llr": stage_busy(llrs),
        "deinterleave_depuncture": stage_busy(deinterleave),
        "viterbi_rows_pad_unfold": stage_busy(
            lambda: fec.viterbi_rows(dep, window=4096)),
        "soft_llr_rows": stage_busy(
            lambda: ks.soft_llr_rows(sig, plan, tab, 1.0)),
        "viterbi_on_rows": stage_busy(lambda: kv.viterbi(*rows)),
        "parent_chain": stage_busy(old_chain),
        "back_end": stage_busy(lambda: fec.decode_payload(sig, cfg)),
    }
    emit({"phase": "coded_stages", "card": card, "rate": "1/2",
          "symbols": list(sig.shape), "coded_llrs": list(lv.shape),
          "rows": list(rows[0].shape), "iters": CODED_ITERS,
          "peak_bytes": peak, "llr_chunk": constellation.LLR_CHUNK,
          **stages})
    del lv, dep

    # real bytes: a full payload of seeded bytes
    data = np.random.default_rng(42).integers(
        0, 256, fec.data_capacity_bytes(cfg), dtype=np.uint8).tobytes()
    planes = planes_of(cfg, fec.encode_data(data, cfg))
    (got, ok), counts = drive(lambda: fec.decode_data(dec(*planes), cfg))
    emit({"phase": "coded_data", "card": card, "bytes": len(data),
          "crc_ok": bool(ok), "exact": got == data,
          "launches": {k: v for k, v in counts.items() if v}})
    require(ok and got == data, "decode_data: CRC or bytes differ")
    require(counts["soft_llr_rows"] == 1 and counts["viterbi"] == 1
            and counts["soft_llr"] == 0, f"decode_data launches {counts}")
    del planes

    # joint soft-output ML on the ML QPSK config
    mcfg = ModemConfig(detector=Detector.ML, modulation=Modulation.QPSK,
                       pid_max=1000, bit_exact=False)
    msg, txd = fec.encode_payload(mcfg, seed=42)
    planes = planes_of(mcfg, txd)
    mdec = rx.make_decoder(mcfg, device=dev, input_format="planes")
    bits, counts = drive(lambda: fec.decode_payload_ml(mdec(*planes), mcfg))
    ber = ber_by_lane(bits, msg)
    t_ml = cuda_ms(lambda: fec.decode_payload_ml(mdec(*planes), mcfg),
                   iters=3, warmup=1)
    emit({"phase": "coded_ml", "card": card, "msg_bits": list(msg.shape),
          "ber": ber, "launches": {k: v for k, v in counts.items() if v},
          "decode_and_ml_back_end_ms": t_ml["median_ms"]})
    require(counts["viterbi"] == 1 and counts["demap"] >= 1
            and counts["soft_llr_rows"] == 1,
            f"coded ML launches {counts}")
    require(all(b == 0.0 for b in ber), f"coded ML: BER {ber}")

    # the LLRs alone in wire order: the same source, the identity geometry
    _, llr_counts = drive(lambda: constellation.soft_demodulate_llr(
        sig, cfg.modulation, 1.0))
    emit({"phase": "soft_demodulate_llr", "card": card,
          "launches": {k: v for k, v in llr_counts.items() if v}})
    require(llr_counts["soft_llr"] == 1, f"soft_demodulate_llr launches "
            f"{llr_counts}")
    return {"counts": main_counts, "llr_counts": llr_counts, "sig": sig,
            "rows": rows}


def viterbi_check(dev, card, rows) -> dict:
    """The Viterbi kernel against viterbi_plain, bit for bit: the
    operating point's rows (its coded decode's windows), one pinned
    codeword of 16,390 steps, seeded rows with exact ties (zero LLRs)
    and +-1e4 pads, pinned and windowed rows mixed, and all-zero rows.
    Returns its row of the kernels line."""
    from rub_mimo_tpu_torch.kernels import viterbi as kv

    def seeded(seed, R, T):
        rng = np.random.default_rng(seed)
        p = (rng.standard_normal((R, T, 2)) * 2.0).astype(np.float32)
        p[:, T // 5:T // 5 + 40] = 0.0
        p[:, T // 2:T // 2 + 20] = 1e4
        p[::2, T // 2 + 20:T // 2 + 30] = -1e4
        return torch.as_tensor(p, device=dev)

    cases = {
        "operating_point": rows,
        "codeword_16390": (seeded(16390, 1, 16390),
                           torch.ones(1, dtype=torch.bool, device=dev)),
        "ties_and_pads": (seeded(700, 37, 700),
                          torch.arange(37, device=dev) % 2 == 0),
        "all_zero": (torch.zeros((4, 500, 2), device=dev),
                     torch.arange(4, device=dev) % 2 == 0),
    }
    # row counts that leave a warp's groups part empty, and short rows
    for R, T in ((1, 1), (2, 31), (3, 33), (5, 700), (37, 31), (1, 33),
                 (2, 4352)):
        cases[f"rows_{R}_steps_{T}"] = (seeded(R * 7 + T, R, T),
                                        torch.arange(R, device=dev) % 2 == 0)
    out = {}
    for name, (p, pin) in cases.items():
        want = kv.viterbi_plain(p, pin)
        got = kv.viterbi(p, pin)
        torch.cuda.synchronize()
        diff = int((got != want).sum())
        out[name] = {"rows": p.shape[0], "steps": p.shape[1],
                     "pinned_rows": int(pin.sum()), "bits_differing": diff}
        require(diff == 0, f"viterbi {name}: {diff} bits differ")
    p, pin = rows
    R, T = p.shape[:2]
    busy = device_busy(lambda: kv.viterbi(p, pin), n=10)["busy_ms"]
    t_k = cuda_ms(lambda: kv.viterbi(p, pin), iters=10)
    t_plain = cuda_ms(lambda: kv.viterbi_plain(p, pin), iters=2, warmup=0)
    t_16k = cuda_ms(lambda: kv.viterbi(*cases["codeword_16390"]), iters=10)
    b = bound(nbytes(p, pin) + R * T * 4, VITERBI_OPS * 64.0 * R * T)
    emit({"phase": "viterbi_vs_plain", "card": card, "cases": out,
          "lanes": VITERBI_LANES, "lanes_tried": VITERBI_LANES_TRIED,
          "kernel_busy_ms": busy, "kernel_event_ms": t_k["median_ms"],
          "before_redesign_quoted": VITERBI_BEFORE_QUOTED,
          "plain_ms": t_plain["median_ms"],
          "codeword_16390_event_ms": t_16k["median_ms"], **b})
    return {"max_abs_err": max(float(v["bits_differing"] > 0)
                               for v in out.values()),
            "ms": busy if busy is not None else t_k["median_ms"],
            "timer": "profiler" if busy is not None else "cuda_events",
            "plain_ms": t_plain["median_ms"], "bound": b,
            "codeword_16390_ms": t_16k["median_ms"], "cases": out}


def llr_bound(n_sym: int, bits: int) -> dict:
    """The max-log LLRs' two bounds: the symbols read and the LLRs written
    once over the memory rate, and the float32 operations the function
    needs over the peak rate.  A point costs |y - c|^2 (two subtracts, two
    multiplies, an add) and one minimum a bit; a symbol then 2 bits
    scalings and bits subtracts.  The kernel's hypotf and its square are
    not counted: they are there only to round as the plain version does."""
    n_bytes = n_sym * (8 + 4 * bits)
    flops = float(n_sym) * ((5 + bits) * (1 << bits) + 3 * bits)
    b = bound(n_bytes, flops)
    return {**b, "bytes_bound_ms": n_bytes / HBM_BYTES_PER_S * 1e3,
            "operations_bound_ms": flops / FP32_FLOPS * 1e3}


def same_llrs(a: torch.Tensor, b: torch.Tensor) -> dict:
    """Values differing between two LLR tensors (NaN equal to NaN), and
    the largest |difference| where both are finite."""
    both_nan = torch.isnan(a) & torch.isnan(b)
    differ = int((~((a == b) | both_nan)).sum())
    fin = torch.isfinite(a) & torch.isfinite(b)
    err = float((a[fin] - b[fin]).abs().max()) if bool(fin.any()) else 0.0
    return {"differing": differ, "max_abs_err": err,
            "nan": int(torch.isnan(b).sum())}


def magnitude_symbols(tab: np.ndarray, n: int, seed: int) -> np.ndarray:
    """n symbols of log-uniform magnitude 2^-20 to 2^20 (inside the soft-LLR
    kernel's fast range, 2^-16 to 2^16, and past it on both sides), an
    eighth real-valued and an eighth imaginary, then the points, the
    midpoints of neighbours and the points moved by 2^-30 to 2^-8
    (tests/test_torch_cuda.py's)."""
    rng = np.random.default_rng(seed)
    y = (2.0 ** rng.uniform(-20, 20, n)
         * np.exp(2j * np.pi * rng.uniform(size=n))).astype(np.complex64)
    y[: n // 8] = y[: n // 8].real
    y[n // 8: n // 4] = 1j * y[n // 8: n // 4].imag
    k = len(tab)
    y[n // 4: n // 4 + k] = tab
    y[n // 4 + k: n // 4 + 2 * k - 1] = (tab[1:] + tab[:-1]) / 2
    m = n // 4 + 2 * k
    near = tab[rng.integers(0, k, 4096)] + (
        2.0 ** rng.uniform(-30, -8, 4096)
        * np.exp(2j * np.pi * rng.uniform(size=4096)))
    y[m: m + 4096] = near.astype(np.complex64)
    return y


def soft_llr_check(dev, card, sig, cfg) -> dict:
    """The soft-LLR kernel against soft_llr_plain, value for value (NaN
    where it is NaN): the operating point's rx_sig (ARB32OPT); seeded
    symbols for BPSK, QPSK, 16-QAM, 64-QAM and QAM256 at an odd count and
    at one symbol, each with NaN, +-Inf and 1e30 rows; 2^20 symbols of
    magnitudes 2^-20 to 2^20 for BPSK, ARB32OPT and QAM256
    (magnitude_symbols: the fast path and the rare path); noise_var as a
    number and as a device tensor.  Times the kernel and the plain
    version on the rx_sig.  Returns its row of the kernels line."""
    from rub_mimo_tpu_torch import Modulation
    from rub_mimo_tpu_torch.kernels import soft_llr as ks
    from rub_mimo_tpu_torch.ofdm import constellation

    tab = constellation.table(cfg.modulation)
    cases = {"operating_point": (sig, tab)}
    for mod in (Modulation.BPSK, Modulation.QPSK, Modulation.QAM16,
                Modulation.ARB32OPT, Modulation.QAM64, Modulation.QAM256):
        t = constellation.table(mod)
        for n in (100_001, 1):
            rng = np.random.default_rng(n + len(t))
            y = ((rng.standard_normal(n) + 1j * rng.standard_normal(n))
                 * 0.8).astype(np.complex64)
            if n > 1:
                y[:8] = [np.nan, np.inf, -np.inf, 1e30, -1e30,
                         complex(np.inf, np.nan), complex(0.0, -np.inf),
                         t[-1]]
            cases[f"{mod.name}_{n}"] = (torch.as_tensor(y, device=dev), t)
    # magnitudes 2^-20 to 2^20, a coordinate 0, on the points, ties, 2^-30
    # to 2^-8 off the points: the fast path (no hypotf) and the rare path
    for mod in (Modulation.BPSK, Modulation.ARB32OPT, Modulation.QAM256):
        t = constellation.table(mod)
        cases[f"{mod.name}_magnitudes"] = (torch.as_tensor(
            magnitude_symbols(t, 1 << 20, len(t) + 17), device=dev), t)
    out = {}
    for name, (y, t) in cases.items():
        for nv_name, nv in (("0.37", 0.37), ("1.0", 1.0),
                            ("tensor_0.37", torch.tensor(0.37, device=dev))):
            got = ks.soft_llr(y, t, nv)
            want = ks.soft_llr_plain(y, t, nv)
            torch.cuda.synchronize()
            r = same_llrs(got, want)
            out[f"{name}/{nv_name}"] = {"symbols": y.numel(),
                                        "points": len(t), **r}
            require(r["differing"] == 0,
                    f"soft_llr {name} noise_var {nv_name}: {r}")
    bits = int(len(tab)).bit_length() - 1
    busy = device_busy(lambda: ks.soft_llr(sig, tab, 1.0), n=10)["busy_ms"]
    t_k = cuda_ms(lambda: ks.soft_llr(sig, tab, 1.0), iters=10)
    t_plain = cuda_ms(lambda: ks.soft_llr_plain(sig, tab, 1.0), iters=5,
                      warmup=1)
    b = llr_bound(sig.numel(), bits)
    emit({"phase": "soft_llr_vs_plain", "card": card, "cases": out,
          "kernel_busy_ms": busy, "kernel_event_ms": t_k["median_ms"],
          "plain_ms": t_plain["median_ms"], **b})
    return {"max_abs_err": max(v["max_abs_err"] for v in out.values()),
            "ms": busy if busy is not None else t_k["median_ms"],
            "timer": "profiler" if busy is not None else "cuda_events",
            "event_ms": t_k["median_ms"], "plain_ms": t_plain["median_ms"],
            "bound": b, "cases": out}


def rows_bound(n_sym: int, bits: int, rows: torch.Tensor) -> dict:
    """The rows kernel's two bounds: the symbols read once and the rows
    written once over the memory rate, and the LLRs' float32 operations
    (llr_bound's, each symbol once) over the peak rate."""
    ops = llr_bound(n_sym, bits)["flops"]
    b = bound(n_sym * 8 + nbytes(rows), ops)
    return {**b, "bytes_bound_ms": b["bytes"] / HBM_BYTES_PER_S * 1e3,
            "operations_bound_ms": ops / FP32_FLOPS * 1e3}


def soft_llr_rows_check(dev, card, sig, cfg) -> dict:
    """The soft-LLR rows kernel against soft_llr_rows_plain, value for
    value (NaN where it is NaN): the operating point's rx_sig at rates
    1/2, 2/3 and 3/4 (the decode's plans: interleaved, windows of 4096),
    noise_var 1.0 and a device tensor, and its LLRs through the LLR-input
    instance; seeded symbols of every modulation, 2 lanes of 20,001 with
    NaN, +-Inf and 1e30 rows, interleaved or not, one row (several tiles)
    or windows of 4096, noise_var a number, a device tensor and 0 (the
    per-point path).  Times the kernel and the plain version on the
    rate-1/2 rows.  Returns its row of the kernels line."""
    from rub_mimo_tpu_torch import Modulation
    from rub_mimo_tpu_torch.kernels import soft_llr as ks
    from rub_mimo_tpu_torch.ofdm import constellation, fec

    tab = constellation.table(cfg.modulation)
    n = sig.shape[1] * cfg.modulation.bits_per_symbol
    cases = {}
    for rate in CODED_RATES:
        cases[f"operating_point_{rate}"] = (sig, tab, fec.row_plan(
            n, cfg, rate), (1.0, torch.tensor(1.0, device=dev)))
    cases["operating_point_llrs"] = (
        ks.soft_llr_plain(sig, tab, 1.0).reshape(sig.shape[0], -1), None,
        fec.row_plan(n, cfg), (1.0,))
    for mod in (Modulation.BPSK, Modulation.QPSK, Modulation.QAM16,
                Modulation.ARB32OPT, Modulation.QAM64, Modulation.QAM256):
        t = constellation.table(mod)
        rng = np.random.default_rng(20_001 + len(t))
        y = ((rng.standard_normal((2, 20_001))
              + 1j * rng.standard_normal((2, 20_001))) * 0.8
             ).astype(np.complex64)
        y[0, :8] = [np.nan, np.inf, -np.inf, 1e30, -1e30,
                    complex(np.inf, np.nan), complex(0.0, -np.inf), t[-1]]
        m = 20_001 * mod.bits_per_symbol
        for rate, stride, window in (
                ("1/2", fec.interleave_stride(m, 127), 4096),
                ("2/3", 1, None), ("3/4", fec.interleave_stride(m, 127),
                                   None), ("3/4", 1, 4096)):
            used = 2 * (m // 2)
            while fec._kept_bits(used, rate) > m:
                used -= 2
            cases[f"{mod.name}_{rate}_s{stride}_w{window}"] = (
                torch.as_tensor(y, device=dev), t,
                ks.RowPlan(used=used, rate=rate, stride=stride,
                           window=window),
                (0.37, torch.tensor(0.37, device=dev), 0.0))
    out = {}
    for name, (x, t, plan, nvs) in cases.items():
        for nv in nvs:
            got = ks.soft_llr_rows(x, plan, t, nv)
            want = ks.soft_llr_rows_plain(x, plan, t, nv)
            torch.cuda.synchronize()
            r = same_llrs(got[0], want[0])
            key = f"{name}/{'tensor' if isinstance(nv, torch.Tensor) else nv}"
            out[key] = {"input": list(x.shape), "rows": list(got[0].shape),
                        "pinned_equal": bool(torch.equal(got[1], want[1])),
                        **r}
            require(r["differing"] == 0 and out[key]["pinned_equal"],
                    f"soft_llr_rows {key}: {out[key]}")
    plan = fec.row_plan(n, cfg)
    rows = ks.soft_llr_rows(sig, plan, tab, 1.0)[0]
    busy = device_busy(lambda: ks.soft_llr_rows(sig, plan, tab, 1.0),
                       n=10)["busy_ms"]
    t_k = cuda_ms(lambda: ks.soft_llr_rows(sig, plan, tab, 1.0), iters=10)
    t_plain = cuda_ms(lambda: ks.soft_llr_rows_plain(sig, plan, tab, 1.0),
                      iters=3, warmup=1)
    b = rows_bound(sig.numel(), cfg.modulation.bits_per_symbol, rows)
    emit({"phase": "soft_llr_rows_vs_plain", "card": card, "cases": out,
          "kernel_busy_ms": busy, "kernel_event_ms": t_k["median_ms"],
          "plain_ms": t_plain["median_ms"], **b})
    return {"max_abs_err": max(v["max_abs_err"] for v in out.values()),
            "ms": busy if busy is not None else t_k["median_ms"],
            "timer": "profiler" if busy is not None else "cuda_events",
            "event_ms": t_k["median_ms"], "plain_ms": t_plain["median_ms"],
            "bound": b, "cases": out}


def sfo_phase(dev, card) -> dict:
    """decode_with_sfo on the full-geometry SFO case (pid_max=64) at 20 and
    100 ppm, |ppm_hat - ppm| < 0.1 ppm + 2 and SER < 0.005, K1 and K4
    counted; then the operating point at 20 ppm, printed."""
    from rub_mimo_tpu_torch import ModemConfig
    from rub_mimo_tpu_torch.estimate import sfo
    from rub_mimo_tpu_torch.io import simulator

    out = {}
    for pid_max, ppms, iters in ((64, SFO_PPMS, 3), (1000, (20.0,), 2)):
        c = ModemConfig(pid_max=pid_max, bit_exact=False)
        n = c.pid_max * c.M_occupied
        for ppm in ppms:
            spec = simulator.ChannelSpec(snr_db=30.0, delay=5000, seed=42,
                                         sfo_ppm=ppm)
            cap, txd, _ = simulator.simulate_capture(c, spec, device=dev)
            (r, d, _), counts = drive(
                lambda: sfo.decode_with_sfo(cap, c, device=dev))
            ppm_hat = float(d) * 1e6
            ser = float((r.rx_data.cpu().numpy()[:, :n]
                         != txd[:, :n]).mean())
            t = cuda_ms(lambda: sfo.decode_with_sfo(cap, c, device=dev),
                        iters=iters, warmup=1)
            busy = device_busy(lambda: sfo.decode_with_sfo(cap, c,
                                                           device=dev),
                               n=1)["busy_ms"]
            name = f"pid_max_{pid_max}_{ppm:g}_ppm"
            out[name] = {"ppm_hat": ppm_hat, "ser": ser,
                         "ms": t["median_ms"], "busy_ms": busy,
                         "launches": {k: v for k, v in counts.items() if v}}
            emit({"phase": "sfo", "case": name, "card": card,
                  "capture": list(cap.shape), "ppm": ppm,
                  "idle_share": None if busy is None
                  else 1.0 - busy / t["median_ms"], **out[name]})
            require(counts["payload_fused_strip"] >= 1
                    and counts["demap"] >= 1 and counts["cp_strip"] >= 1,
                    f"decode_with_sfo launches {counts}")
            if pid_max == 64:
                require(abs(ppm_hat - ppm) < 0.1 * ppm + 2.0,
                        f"{name}: ppm_hat {ppm_hat}")
                require(ser < 0.005, f"{name}: SER {ser}")
            del cap
    return out


def three_bursts(cfg, dev, ppm: float):
    """tests/test_sfo_streaming.py's capture built by the port: three
    frames (payload seeds 1, 2, 3) a replay window and three symbols
    apart, 35 dB, channel seed 3, sfo_ppm (capture, tx data of each)."""
    from rub_mimo_tpu_torch.io import simulator
    from rub_mimo_tpu_torch.ofdm import framegen

    spec = simulator.ChannelSpec(snr_db=35.0, delay=0, trailing=0, seed=3,
                                 sfo_ppm=ppm)
    h = simulator.draw_channel(spec, 2, 2)
    data = [framegen.generate_payload_symbols(cfg, seed=s) for s in (1, 2, 3)]
    gap = cfg.window_len + 3 * cfg.symbol_len
    parts = [torch.zeros((2, 300), dtype=torch.complex64, device=dev)]
    for d in data:
        t = framegen.transmit_frame(cfg, d, device=dev)
        parts += [t, torch.zeros((2, max(64, gap - t.shape[-1])),
                                 dtype=torch.complex64, device=dev)]
    parts.append(torch.zeros((2, 500), dtype=torch.complex64, device=dev))
    return simulator.apply_channel(torch.cat(parts, dim=-1), h, spec,
                                   cfg), data


def stream_sfo(cfg, cap: torch.Tensor, C: int, device):
    """cap streamed with sfo_correct in chunks of C on ``device`` and
    finalized: (decoder, wall seconds, each burst's SER)."""
    from rub_mimo_tpu_torch.pipeline import streaming

    dec = streaming.StreamingDecoder(cfg, device=device, chunk_size=C,
                                     sfo_correct=True)
    x = torch.nn.functional.pad(cap, (0, -(-cap.shape[-1] // C) * C
                                      - cap.shape[-1])).to(device)
    sync_all()
    t0 = time.perf_counter()
    for i in range(x.shape[-1] // C):
        dec.push(x[:, i * C:(i + 1) * C])
    dec.finalize()
    sync_all()
    return dec, time.perf_counter() - t0


def streaming_sfo_phase(dev, card) -> dict:
    """Live SFO correction (StreamingDecoder(sfo_correct=True)): the
    three-burst 100 ppm capture at tests/test_sfo_streaming.py's tiny
    geometry on the card, held to that test's thresholds and equal to the
    port's CPU stream of the same capture; then the three-burst layout at
    full geometry (pid_max=64, 20 ppm), printed."""
    from rub_mimo_tpu_torch import ModemConfig, Modulation, tiny_config

    out = {}
    for name, cfg, ppm, C in (
            ("tiny_100_ppm", tiny_config(
                bit_exact=False, pid_max=64, modulation=Modulation.QAM16,
                track_channel=True, sync_fallback=True), 100.0, 512),
            ("full_geometry_20_ppm", ModemConfig(
                pid_max=64, bit_exact=False, track_channel=True), 20.0,
             65536)):
        cap, data = three_bursts(cfg, dev, ppm)
        (dec, wall), counts = drive(lambda: stream_sfo(cfg, cap, C, dev))
        n = cfg.pid_max * cfg.M_occupied
        sers = [float((d.cpu().numpy()[:, :n] != tx[:, :n]).mean())
                for (_, _, d), tx in zip(dec.burst_results(), data)]
        rec = {"bursts": len(dec.bursts), "sfo_hat_ppm": dec.sfo_hat * 1e6,
               "ser_by_burst": sers, "stream_s": wall,
               "iq_samples_per_s": cap.shape[-1] / wall,
               "host_reads": dec.host_reads,
               "launches": {k: v for k, v in counts.items() if v}}
        if name.startswith("tiny"):
            cpu, _ = stream_sfo(cfg, cap.cpu(), C, "cpu")
            same = (len(cpu.bursts) == len(dec.bursts)
                    and all(si == sj and torch.equal(a.cpu(), b)
                            for (si, _, a), (sj, _, b) in zip(
                                dec.burst_results(), cpu.burst_results())))
            rec.update(cpu_sfo_hat_ppm=cpu.sfo_hat * 1e6,
                       equal_to_cpu_stream=same)
            require(len(dec.bursts) == 3, f"{name}: {len(dec.bursts)} bursts")
            require(abs(dec.sfo_hat * 1e6 - 100.0) < 15.0,
                    f"{name}: sfo_hat {dec.sfo_hat * 1e6} ppm")
            require(sers[1] < 0.6 * sers[0] and sers[2] < 0.6 * sers[0],
                    f"{name}: SER by burst {sers}")
            require(same and abs(cpu.sfo_hat - dec.sfo_hat) < 1e-6,
                    f"{name}: the card's stream differs from the CPU's")
            require(counts["cp_strip"] >= 1 and counts["demap"] >= 1,
                    f"{name}: launches {counts}")
        emit({"phase": "streaming_sfo", "case": name, "card": card,
              "capture": list(cap.shape), "chunk": C, "ppm": ppm, **rec})
        out[name] = rec
    return out


# ---- the command line (apps/cli.py) at the CLI's default geometry ----
# run's impairment for the front-end cases (tests/test_frontend.py:40-60's
# amplitude and phase; the CLI's --dc-offset is real)
CLI_IQ_IMBALANCE, CLI_DC_OFFSET = (1.0, 5.0), 0.05
CLI_FILE_BYTES = 65536  # --send-file's seeded payload
CLI_LISTEN_CHUNK = 4096  # listen's default --chunk
CLI_FRONTEND_CHUNK = 65536  # the streamed front end's chunk
CLI_FRONTEND_SER_MAX = 1e-4  # SER with --frontend-comp at 30 dB
CLI_W_TOL = 0.04  # |w - nu / conj(mu)| (tests/test_frontend.py:60)


def run_cli(argv: list) -> tuple:
    """cli.main(argv) in this process: (exit code, what it printed)."""
    import contextlib
    import io

    from rub_mimo_tpu_torch.apps import cli

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = cli.main([str(a) for a in argv])
    torch.cuda.synchronize()
    return rc, buf.getvalue()


def printed(out: str, label: str) -> list:
    """The numbers of the CLI's `label` lines ("symbol error rate",
    "coded BER lane"), in percent."""
    return [float(ln.split(":")[1].strip().rstrip("%"))
            for ln in out.splitlines() if label in ln]


def cli_spec(**kw):
    """The ChannelSpec `cli run` builds from its default flags (30 dB,
    delay 5000, seed 42) and kw."""
    from rub_mimo_tpu_torch.io import simulator

    return simulator.ChannelSpec(snr_db=30.0, delay=5000, seed=42, **kw)


def cli_listen(card, cfg, directory: Path, T: int) -> dict:
    """`listen` in this process (a thread, its launches counted) fed by
    `send` as a process of its own over 127.0.0.1, from the capture
    directory; SER 0, samples/s a stream from the send's start to the
    decoder's result."""
    import contextlib
    import io
    import socket
    import threading

    from rub_mimo_tpu_torch.apps import cli
    from rub_mimo_tpu_torch.io import native

    require(native.available(), "the native ingest library did not build")
    with socket.socket() as s:  # a free port for the listener
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    buf, result = io.StringIO(), {}

    def listen():
        try:
            result["rc"] = cli.main(["listen", "--port", str(port),
                                     "--chunk", str(CLI_LISTEN_CHUNK),
                                     "--tx-data", str(directory)])
            torch.cuda.synchronize()
        except BaseException as e:  # raised again below, in the caller
            result["error"] = e
        result["t_end"] = time.perf_counter()

    wrappers = launch_counts()
    for w in wrappers.values():
        w.launches = 0
    with contextlib.redirect_stdout(buf):
        th = threading.Thread(target=listen)
        th.start()
        deadline = time.time() + 120
        while "listening on" not in buf.getvalue() and th.is_alive():
            require(time.time() < deadline, "listen did not bind")
            time.sleep(0.05)
        t0 = time.perf_counter()
        send = subprocess.run(
            [sys.executable, "-m", "rub_mimo_tpu_torch.apps.cli", "send",
             str(directory), "--port", str(port)],
            capture_output=True, text=True, timeout=300, cwd=REPO)
        th.join(timeout=600)
    require(not th.is_alive(), "listen did not end")
    if "error" in result:
        raise result["error"]
    require(send.returncode == 0, f"send: {send.stdout}{send.stderr}")
    out = buf.getvalue()
    counts = {name: w.launches for name, w in wrappers.items()}
    sers = printed(out, "symbol error rate")
    wall = result["t_end"] - t0
    rec = {"phase": "cli", "case": "send_listen", "card": card,
           "chunk": CLI_LISTEN_CHUNK, "native": native.available(),
           "samples_per_stream": T, "rc": result["rc"],
           "ser_percent": sers, "send_to_result_s": wall,
           "samples_per_s_per_stream": T / wall,
           "launches": {k: counts[k] for k in
                        ("sc_metric", "payload_fused_strip", "demap")}}
    emit(rec)
    require(result["rc"] == 0 and "synced=True" in out, out)
    require(sers == [0.0] * cfg.num_streams, f"listen SER {sers}")
    require(all(v >= 1 for v in rec["launches"].values()),
            f"listen launches {rec['launches']}")
    return rec


def cli_frontend(dev, card, cfg, tmp: Path) -> dict:
    """run with the impairment, without and with --frontend-comp; the
    moments against the closed form and their device time against the
    bytes bound on the [2, T] capture; the streamed front end against the
    offline decode_with_frontend, with no host read in its payload
    phase."""
    from rub_mimo_tpu_torch.estimate import frontend
    from rub_mimo_tpu_torch.io import simulator
    from rub_mimo_tpu_torch.pipeline import checkpoint, streaming

    amp, deg = CLI_IQ_IMBALANCE
    imp = ["--iq-imbalance", f"{amp},{deg}", "--dc-offset", CLI_DC_OFFSET]
    rc0, out0 = run_cli(["run", *imp])
    ck = tmp / "frontend.npz"
    (rc1, out1), counts = drive(lambda: run_cli(
        ["run", *imp, "--frontend-comp", "--save-checkpoint", ck]))
    ser0, ser1 = printed(out0, "symbol error rate"), printed(
        out1, "symbol error rate")
    spec = cli_spec(iq_amp_db=amp, iq_phase_deg=deg, dc_offset=CLI_DC_OFFSET)
    cap, tx_data, _ = simulator.simulate_capture(cfg, spec, payload_seed=42,
                                                 device=dev)
    dc, w = frontend.estimate_frontend(cap)
    g, phi = 10.0 ** (amp / 20.0), np.deg2rad(deg)
    w_true = ((1.0 - g * np.exp(-1j * phi)) / 2.0
              / np.conj((1.0 + g * np.exp(1j * phi)) / 2.0))
    w_err = float(np.abs(w.cpu().numpy() - w_true).max())
    r_off, _, _ = frontend.decode_with_frontend(cap, cfg, device=dev)
    cli_same = bool(np.array_equal(checkpoint.load(ck).rx_data,
                                   r_off.rx_data.cpu().numpy()))

    def fe():
        return frontend.compensate(cap, *frontend.estimate_frontend(cap))

    busy = device_busy(fe, n=10)
    # the moments read the capture once, the compensation reads it and
    # writes its output: three passes of [S, T] complex64; ~20 float32
    # operations a sample (the three moments, the conjugate product)
    fe_bound = bound(3 * nbytes(cap), 20.0 * cap.numel())
    fe_ms = busy["busy_ms_median"] or busy["busy_ms"]
    emit({"phase": "cli", "case": "frontend_offline", "card": card,
          "capture": list(cap.shape), "iq_imbalance_db_deg": [amp, deg],
          "dc_offset": CLI_DC_OFFSET, "rc": [rc0, rc1],
          "ser_percent_without": ser0, "ser_percent_with": ser1,
          "w": [[v.real, v.imag] for v in w.cpu().numpy().tolist()],
          "w_closed_form": [w_true.real, w_true.imag],
          "w_max_abs_err": w_err,
          "dc": [[v.real, v.imag] for v in dc.cpu().numpy().tolist()],
          "cli_equals_decode_with_frontend": cli_same,
          "frontend_device_ms": fe_ms,
          "frontend_event_ms": cuda_ms(fe)["median_ms"],
          "frontend_kernels_us": busy["kernels_us"],
          "frontend_bound_ms": fe_bound["bound_ms"],
          "frontend_bound_by": fe_bound["bound_by"],
          "frontend_bound_share": (None if not fe_ms
                                   else fe_bound["bound_ms"] / fe_ms),
          "launches": {k: v for k, v in counts.items() if v}})
    require(rc0 == 0 and rc1 == 0, "run with the impairment failed")
    require(min(ser0) > max(ser1), f"SER without {ser0}, with {ser1}")
    require(max(ser1) <= CLI_FRONTEND_SER_MAX * 100, f"SER with {ser1}")
    require(w_err < CLI_W_TOL, f"w off the closed form by {w_err}")
    require(cli_same, "run --frontend-comp differs from decode_with_frontend")

    def stream():
        dec = streaming.StreamingDecoder(cfg, device=dev,
                                         chunk_size=CLI_FRONTEND_CHUNK,
                                         frontend_comp=True)
        feed(dec, cap)
        return dec, dec.result()[1]

    (dec, data), counts = drive(stream)
    mism = int((data != r_off.rx_data).sum())
    ser = stream_ser(data, tx_data, cfg)
    strict = streaming.StreamingDecoder(cfg, device=dev,
                                        chunk_size=CLI_FRONTEND_CHUNK,
                                        frontend_comp=True)
    pushes, secs = payload_span(strict, cap, strict=True)
    emit({"phase": "cli", "case": "frontend_streamed", "card": card,
          "chunk": CLI_FRONTEND_CHUNK, "warmup_chunks": 4,
          "sync_index": dec.sync_index,
          "offline_sync_index": int(r_off.sync_index),
          "mismatches_vs_offline": mism, "ser": ser,
          "host_reads": dec.host_reads,
          "payload_pushes_without_host_read": pushes,
          "payload_push_ms": secs / max(pushes, 1) * 1e3,
          "launches": {k: v for k, v in counts.items() if v}})
    require(mism == 0 and dec.sync_index == int(r_off.sync_index),
            f"streamed front end: {mism} mismatches against offline")
    require(pushes >= 1, "no payload push checked")
    return {"ser_without": ser0, "ser_with": ser1, "w_err": w_err,
            "device_ms": fe_ms, "bound_ms": fe_bound["bound_ms"]}


def cli_phase(dev, card) -> dict:
    """The port's command line (apps/cli.py) driven through cli.main at
    its default geometry, the operating point (M=2048, CP=152, 2x2, 20
    codes, 1000 ARB32OPT frames, ZF, 30 dB, delay 5000, seed 42): run
    (SER 0, K1 once a decode, decisions equal rx.decode's), transmit then
    decode through files (the TX files through the simulated channel,
    SER 0), send / listen over 127.0.0.1 (listen's chunk 4096), the front
    end offline and streamed, --precoded (SER 0 both rounds), --fec at
    rates 1/2 and 3/4 (BER 0), --send-file (64 KB exact), the checkpoint
    resumed (equal to the decode, from frame 0 and 500), --profile and
    --trace-dir.  One line a case; a failed case raises."""
    import tempfile

    from rub_mimo_tpu_torch import ModemConfig

    cfg = ModemConfig(pid_max=1000)  # the CLI's defaults
    with tempfile.TemporaryDirectory(prefix="cli_") as tmp:
        return cli_cases(dev, card, cfg, Path(tmp))


def cli_cases(dev, card, cfg, tmp: Path) -> dict:
    """cli_phase's cases, their files in tmp."""
    from rub_mimo_tpu_torch.io import capture as capio
    from rub_mimo_tpu_torch.io import simulator
    from rub_mimo_tpu_torch.pipeline import checkpoint, rx

    out = {}

    # run: the JSON report; decisions (from its checkpoint) equal rx.decode
    ck = tmp / "run.npz"
    (rc, text), counts = drive(lambda: run_cli(
        ["run", "--json", "--save-checkpoint", ck]))
    rep = json.loads(text)
    cap, tx_data, h = simulator.simulate_capture(cfg, cli_spec(),
                                                 payload_seed=42, device=dev)
    ref = rx.make_decoder(cfg, device=dev)(cap)
    ckpt = checkpoint.load(ck)
    same = bool(np.array_equal(ckpt.rx_data, ref.rx_data.cpu().numpy()))
    emit({"phase": "cli", "case": "run", "card": card, "rc": rc,
          "capture": list(cap.shape), "synced": rep["synced"],
          "ser_percent": rep["symbol_error_rate"],
          "decode_seconds": rep["decode_seconds"],
          "samples_per_second": rep["samples_per_second"],
          "decodes": 2, "equal_to_rx_decode": same,
          "launches": {k: v for k, v in counts.items() if v}})
    require(rc == 0 and rep["synced"], "cli run failed")
    require(rep["symbol_error_rate"] == [0.0, 0.0],
            f"cli run SER {rep['symbol_error_rate']}")
    require(counts["payload_fused_strip"] == 2,
            f"cli run: K1 {counts['payload_fused_strip']} for 2 decodes")
    require(same, "cli run's decisions differ from rx.decode's")
    out["run"] = rep

    # the checkpoint resumed: the decode's decisions, from 0 and 500
    for k in (0, cfg.pid_max // 2):
        (res, counts) = drive(lambda: checkpoint.resume_decode(
            cap, ckpt, from_frame=k, device=dev))
        data = res[1].cpu().numpy()
        same = bool(np.array_equal(data,
                                   ckpt.rx_data[:, k * cfg.M_occupied:]))
        emit({"phase": "cli", "case": "checkpoint_resume", "card": card,
              "from_frame": k, "equal_to_decode": same,
              "launches": {n: v for n, v in counts.items() if v}})
        require(same, f"resume from frame {k} differs from the decode")
        require(counts["payload_fused_strip"] == 1, f"resume: {counts}")

    # transmit, then the TX files through the channel, then decode
    txd = tmp / "tx"
    (rc, text), counts = drive(lambda: run_cli(["transmit", txd, "-q"]))
    require(rc == 0, "cli transmit failed")
    tx = torch.as_tensor(capio.read_capture(txd, 2, prefix="tx"),
                         device=dev)
    capio.write_capture(txd, simulator.apply_channel(
        tx, h, cli_spec(), cfg).cpu().numpy(), prefix="rx")
    (rc, text), counts = drive(lambda: run_cli(
        ["decode", txd, "--tx-data", txd, "--json"]))
    rep = json.loads(text)
    emit({"phase": "cli", "case": "transmit_decode", "card": card,
          "rc": rc, "tx_samples": tx.shape[-1],
          "ser_percent": rep["symbol_error_rate"],
          "launches": {k: v for k, v in counts.items() if v}})
    require(rc == 0 and rep["symbol_error_rate"] == [0.0, 0.0],
            f"transmit -> decode SER {rep['symbol_error_rate']}")
    out["send_listen"] = cli_listen(card, cfg, txd,
                                    capio.read_capture(txd, 2).shape[-1])
    out["frontend"] = cli_frontend(dev, card, cfg, tmp)

    # precoded: both rounds SER 0
    (rc, text), counts = drive(lambda: run_cli(["run", "--precoded"]))
    sers = printed(text, "symbol error rate")
    emit({"phase": "cli", "case": "precoded", "card": card, "rc": rc,
          "ser_percent_rounds": sers,
          "launches": {k: v for k, v in counts.items() if v}})
    require(rc == 0 and "precoded round" in text and sers == [0.0] * 4,
            f"precoded SER {sers}")

    # coded: BER 0 at 1/2 and 3/4
    for rate in ("1/2", "3/4"):
        (rc, text), counts = drive(lambda: run_cli(
            ["run", "--fec", "conv_k7", "--fec-rate", rate]))
        bers = printed(text, "coded BER lane")
        emit({"phase": "cli", "case": "fec", "card": card, "rate": rate,
              "rc": rc, "ber_percent": bers,
              "launches": {k: v for k, v in counts.items() if v}})
        require(rc == 0 and bers == [0.0, 0.0], f"fec {rate} BER {bers}")
        require(counts["viterbi"] == 1 and counts["soft_llr_rows"] == 1
                and counts["soft_llr"] == 0, f"fec {rate}: {counts}")

    # a seeded 64 KB file, recovered exact
    src, dst = tmp / "file.bin", tmp / "file.out"
    src.write_bytes(np.random.default_rng(42).integers(
        0, 256, CLI_FILE_BYTES, dtype=np.uint8).tobytes())
    (rc, text), counts = drive(lambda: run_cli(
        ["run", "--send-file", src, "--recv-out", dst]))
    exact = dst.exists() and dst.read_bytes() == src.read_bytes()
    emit({"phase": "cli", "case": "send_file", "card": card, "rc": rc,
          "bytes": CLI_FILE_BYTES, "crc_ok": "crc_ok=True" in text,
          "exact": exact,
          "launches": {k: v for k, v in counts.items() if v}})
    require(rc == 0 and "crc_ok=True" in text and exact,
            "send-file not recovered")

    # --profile and --trace-dir
    trace_dir = tmp / "trace"
    rc, text = run_cli(["run", "--profile", "--trace-dir", trace_dir])
    stages = {}
    for ln in text.splitlines():
        name = ln.split(":")[0].strip()
        if name in ("sc_metric", "sync_full", "full_decode"):
            rest = ln.split(":")[1].split()
            stages[name] = {"ms": float(rest[0]),
                            "samples_per_s": float(rest[2])}
    trace = trace_dir / "trace.json"
    emit({"phase": "cli", "case": "profile_trace", "card": card, "rc": rc,
          "stages": stages, "trace_file": trace.exists(),
          "trace_bytes": trace.stat().st_size if trace.exists() else 0})
    require(rc == 0 and len(stages) == 3 and trace.exists(),
            "--profile / --trace-dir")
    out["stages"] = stages
    return out


MP_ITERS = 10       # timed decodes of each multi-process case (rank 0's)
MP_HALO_CALLS = 200  # back-to-back K8 exchanges a rank, bit for bit
MP_TIMEOUT = 420.0  # a launch's limit: a hung rank fails the phase
APPS_CHUNK = 65536  # live_view's replay chunk (the streaming default)


def wall_ms(fn, n: int = MP_ITERS) -> dict:
    """Host wall ms of fn() synchronized at both ends on every card,
    median (min, max) of n runs after one warm-up."""
    fn()
    sync_all()
    wall = []
    for _ in range(n):
        t0 = time.perf_counter()
        fn()
        sync_all()
        wall.append((time.perf_counter() - t0) * 1e3)
    return {"median": statistics.median(wall), "min": min(wall),
            "max": max(wall), "runs": n}


def k8_rank_bound(k8: dict) -> float:
    """The bound (ms) of one rank's cross-process K8 launch: its shards'
    [S, M-1] complex64 halos read (those with a left neighbour) and
    written once over HBM, or the remote reads over NVLink where the
    neighbour rank's buffer is on another card, the larger of the two."""
    S, H = k8["halo"]
    halo = S * H * 8
    t_hbm = (k8["reads"] + k8["shards"]) * halo / HBM_BYTES_PER_S
    t_link = (k8["remote_reads"] * halo / NVLINK_BYTES_PER_S
              if k8["remote_on_another_card"] else 0.0)
    return max(t_hbm, t_link) * 1e3


def k8_summary(by_rank: list) -> dict:
    """The cross-process K8's numbers a rank, where it ran: the kernel's
    own split (publish, the neighbour's wait, the pull; µs), the host time
    of a call alone and with its stream synchronized (ms), host syncs and
    launches a call over the back-to-back calls and their bit equality."""
    k8 = [k for k in by_rank if k is not None]
    if not k8:
        return {}
    return {"k8_split_us_by_rank": [k.get("split_us") for k in k8],
            "k8_launch_ms_by_rank": [k.get("launch_ms_median") for k in k8],
            "k8_synced_ms_by_rank": [k.get("exchange_wall_ms_median")
                                     for k in k8],
            "k8_back_to_back_ms_by_rank": [k.get("back_to_back_ms_per_call")
                                           for k in k8],
            "k8_host_syncs_per_call": max(k["host_syncs_per_call"]
                                          for k in k8),
            "k8_launches_per_call": max(k["launches_per_call"] for k in k8),
            "k8_back_to_back_calls": k8[0]["back_to_back_calls"],
            "k8_back_to_back_bit_equal": all(k["back_to_back_bit_equal"]
                                             for k in k8)}


def check_ranks(name: str, recs: list, ranks: int, expect: dict) -> dict:
    """The multi-process records of one case: every rank equal to its
    single decode with SER 0, its launches as ``expect`` (kernels not
    named: 0) and, where K8 ran, its halos bit for bit; returns rank 0's
    record with the ranks' launches and K8 checks beside it."""
    require(sorted(r["rank"] for r in recs) == list(range(ranks)),
            f"multiprocess {name}: records of ranks "
            f"{sorted(r['rank'] for r in recs)}")
    want = {k: expect.get(k, 0) for k in KERNELS}
    for r in recs:
        require(r["equal_to_single"], f"multiprocess {name}: rank "
                f"{r['rank']} differs from the single decode: {r}")
        require(all(x == 0.0 for x in r["ser_percent"]),
                f"multiprocess {name}: rank {r['rank']} SER "
                f"{r['ser_percent']}")
        require(r["launches"] == want, f"multiprocess {name}: rank "
                f"{r['rank']} launches {r['launches']}, expected {want}")
        require(not r["jax_loaded"], f"multiprocess {name}: jax imported")
        if "k8" in r:
            k8 = r["k8"]
            require(k8["bit_equal"] and k8["back_to_back_bit_equal"],
                    f"multiprocess {name}: rank {r['rank']}'s K8 differs "
                    "from its plain version")
            require(k8["host_syncs_per_call"] == 0
                    and k8["launches_per_call"] == 1,
                    f"multiprocess {name}: rank {r['rank']}'s K8 made "
                    f"{k8['host_syncs_per_call']} host syncs and "
                    f"{k8['launches_per_call']} launches a call")
    r0 = min(recs, key=lambda r: r["rank"])
    return {**r0, "launches_by_rank": [r["launches"] for r in recs],
            "k8_by_rank": [r.get("k8") for r in recs]}


def multiprocess_phase(card: str, shard_runs: dict, xc) -> dict:
    """The sharded decode across processes (parallel.multiprocess, one
    process a rank, each held against the single decode on its own card
    and printing its record): on one card, 2 gloo ranks of 2 time shards
    each on cuda:0, the operating point's (4, 1) mesh under pallas_dma
    (K8 pulling through the other rank's IPC-mapped buffer, K6 and K1 on
    the rank's shards) and ppermute (the coarse sync, K1); on 2+ cards one
    NCCL rank a card at (n, 1), and on four mimo_4x4_wideband (4, 1) with
    pallas_dma.  Rank 0's wall ms a decode (median of MP_ITERS) beside
    the single-controller decode of the same mesh, timed here."""
    from rub_mimo_tpu_torch.parallel import multiprocess as mp

    def k1_k6_k8(shards, impl):
        dma = impl == "pallas_dma"
        return {"payload_fused_strip": shards, "sc_metric": int(dma),
                "ring_shift_right": int(dma)}

    out = {}
    cases = [("one_card_gloo", 2, 2, "cuda:0", "gloo", "operating_point",
              (4, 1), 42, {impl: shard_runs[f"{impl}_4x1"]
                           for impl in ("pallas_dma", "ppermute")})]
    cards = torch.cuda.device_count()
    if xc is not None:
        n = xc["n_time"]
        cases.append((f"cards_nccl_{n}x1", n, 1, "cuda", "nccl",
                      "operating_point", (n, 1), 42,
                      {impl: xc["runs"][f"{impl}_{n}x1"]
                       for impl in ("pallas_dma", "ppermute")}))
        if n >= 4:
            cases.append(("cards_nccl_mimo_4x4_wideband", 4, 1, "cuda",
                          "nccl", "mimo_4x4_wideband", (4, 1), 6,
                          {"pallas_dma": xc["runs"][
                              "mimo_4x4_wideband_pallas_dma_4x1"]}))
    else:
        emit({"phase": "multiprocess", "case": "across_cards", "run": False,
              "cards": cards})
    for (name, ranks, per, device, backend, config, shape, seed,
         singles) in cases:
        single_ms = {impl: wall_ms(lambda d=d, p=p: d(*p))
                     for impl, (d, p) in singles.items()}
        t0 = time.perf_counter()
        recs = mp.launch(ranks, per, device=device, backend=backend,
                         halo_impl=tuple(singles), config=config,
                         meshes=(shape,), seeds=(seed,),
                         timing_iters=MP_ITERS, timeout=MP_TIMEOUT,
                         halo_calls=MP_HALO_CALLS)
        launch_s = time.perf_counter() - t0
        for impl in singles:
            r0 = check_ranks(f"{name}/{impl}", [
                r for r in recs if r["halo_impl"] == impl], ranks,
                k1_k6_k8(per, impl))
            rec = {"phase": "multiprocess", "case": name, "card": card,
                   "config": config, "halo_impl": impl, "ranks": ranks,
                   "shards_per_rank": per, "backend": backend,
                   "mesh": list(shape), "capture": r0["capture"],
                   "launches_per_rank": r0["launches_by_rank"],
                   "equal_to_single": True, "ser_percent": r0["ser_percent"],
                   "G_max_abs_err": r0["G_max_abs_err"],
                   "mismatches": r0["mismatches"],
                   "k8_by_rank": r0["k8_by_rank"],
                   **k8_summary(r0["k8_by_rank"]),
                   "wall_ms_rank0": r0["wall_ms"],
                   "single_controller_wall_ms": single_ms[impl],
                   "launch_seconds": launch_s}
            emit(rec)
            out[f"{name}/{impl}"] = rec
    return out


def apps_phase(dev, card: str, cfg, cap: torch.Tensor, tx_data) -> dict:
    """apps.live_view's replay of the operating point through a LiveView
    served on 127.0.0.1 (chunks of APPS_CHUNK: 1,000 frames, SER 0 from
    the frames it took, its JSON snapshot; samples/s a stream beside
    decode_stream without the view, both warm); apps.analyze on `cli run
    --log-dir`'s artifacts (its SER equal to the run's); report_html
    where matplotlib is installed."""
    import tempfile
    import urllib.request

    from rub_mimo_tpu_torch.apps import analyze, live_view
    from rub_mimo_tpu_torch.ofdm import constellation
    from rub_mimo_tpu_torch.pipeline import streaming

    S, T = cap.shape
    view = live_view.LiveView(cfg, port=0)
    port = view.start()
    try:
        live_view.replay(live_view.LiveView(cfg), cap, cfg, device=dev,
                         chunk_size=APPS_CHUNK)  # warm-up
        sync_all()
        t0 = time.perf_counter()
        (dec, shown), counts = drive(lambda: live_view.replay(
            view, cap, cfg, device=dev, chunk_size=APPS_CHUNK))
        view_s = time.perf_counter() - t0
        snap = json.loads(urllib.request.urlopen(
            f"http://127.0.0.1:{port}/data.json", timeout=10).read())
    finally:
        view.stop()
    require(sorted(shown) == list(range(cfg.pid_max)),
            f"live_view: {len(shown)} frames, expected {cfg.pid_max}")
    rx_sig = torch.stack([shown[k] for k in range(cfg.pid_max)], dim=1)
    ser = stream_ser(constellation.demodulate(rx_sig.reshape(S, -1),
                                              cfg.modulation), tx_data, cfg)
    require(all(x == 0.0 for x in ser), f"live_view: SER {ser}")
    require(snap["n_frames"] == cfg.pid_max and snap["synced"]
            and snap["phase"] == "done", f"live_view snapshot: {snap}")

    def stream():
        d = streaming.decode_stream(cap, cfg, APPS_CHUNK, device=dev)
        d.finalize()
        return d

    stream()
    sync_all()
    t0 = time.perf_counter()
    stream()
    sync_all()
    plain_s = time.perf_counter() - t0
    emit({"phase": "apps", "case": "live_view", "card": card,
          "capture": [S, T], "chunk": APPS_CHUNK, "frames": len(shown),
          "ser_percent": ser, "snapshot_n_frames": snap["n_frames"],
          "launches": counts, "seconds_with_view": view_s,
          "seconds_decode_stream": plain_s,
          "samples_per_s_per_stream_with_view": T / view_s,
          "samples_per_s_per_stream_decode_stream": T / plain_s})
    with tempfile.TemporaryDirectory(prefix="apps_") as tmp:
        rc, text = run_cli(["run", "--json", "--log-dir", tmp])
        rep = json.loads(text)
        art = analyze.load(tmp, cfg.num_streams)
        stats = analyze.analyze(art, cfg.M_occupied)
        a_ser = [float(x) * 100.0 for x in stats["ser"]]
        require(rc == 0 and all(abs(a - b) < 1e-9 for a, b in zip(
            a_ser, rep["symbol_error_rate"])),
            f"analyze SER {a_ser} vs the run's {rep['symbol_error_rate']}")
        emit({"phase": "apps", "case": "analyze", "card": card, "rc": rc,
              "ser_percent_analyze": a_ser,
              "ser_percent_run": rep["symbol_error_rate"],
              "errors_total": stats["errors_total"].tolist(),
              "artifacts": sorted(p.name for p in Path(tmp).iterdir())[:8]})
        try:
            import matplotlib  # noqa: F401
        except ImportError:
            emit({"phase": "apps", "case": "report_html", "run": False,
                  "why": "matplotlib is not installed here; render imports "
                         "it (tests/test_torch_apps.py runs it on the CPU)"})
        else:
            from rub_mimo_tpu_torch.apps import report_html

            html = report_html.render(tmp, cfg, Path(tmp) / "report.html",
                                      report_json=text)
            emit({"phase": "apps", "case": "report_html", "run": True,
                  "bytes": html.stat().st_size})
    return {"ser": ser, "frames": len(shown)}


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke.py: torch.cuda.is_available() is "
                         "false; this check runs only on a CUDA device")
    from rub_mimo_tpu_torch import (CommMode, Detector, ModemConfig,
                                    Modulation, tiny_config)
    from rub_mimo_tpu_torch.detect import zf
    from rub_mimo_tpu_torch.io import native, simulator
    from rub_mimo_tpu_torch.kernels import _build
    from rub_mimo_tpu_torch.kernels import cp_strip as k7
    from rub_mimo_tpu_torch.kernels import eq_demap as k34
    from rub_mimo_tpu_torch.kernels import halo_dma as k8
    from rub_mimo_tpu_torch.kernels import payload_fused as pf
    from rub_mimo_tpu_torch.kernels import sc_metric as k6
    from rub_mimo_tpu_torch.kernels import sc_sync as k5
    from rub_mimo_tpu_torch.kernels import soft_llr as ks
    from rub_mimo_tpu_torch.kernels import viterbi as kv
    from rub_mimo_tpu_torch.models import presets
    from rub_mimo_tpu_torch.parallel import mesh as pmesh
    from rub_mimo_tpu_torch.ofdm import constellation
    from rub_mimo_tpu_torch.pipeline import report, rx

    t_start = time.perf_counter()
    dev = torch.device("cuda")
    card = card_line()
    print(card, flush=True)

    # ---- phase 1: device + kernel builds (one nvcc per source, at once)
    sources = sorted({src for _, _, src, _ in KERNELS.values()})
    t0 = time.perf_counter()
    libs = _build.build_all(sources)
    pf._kernel_fn()
    pf._k2_fn()
    k34._lib()
    k7._kernel_fn()
    k5._kernel()
    k6._kernel()
    k8._lib()
    kv._kernel_fn()
    ks._kernel_fn()
    build_s = time.perf_counter() - t0
    # the native ingest library (g++, native/ingest.cpp): listen's socket
    t0 = time.perf_counter()
    require(native.available(), "the native ingest library did not build")
    native_build_s = time.perf_counter() - t0
    emit({"phase": "device", "card": card,
          "torch": torch.__version__, "cuda": torch.version.cuda,
          "name": torch.cuda.get_device_name(0),
          "kernel_build_s": build_s,
          "native_ingest": str(native.library_path().name),
          "native_build_s": native_build_s,
          "ptxas": {name: [ln.strip() for ln in
                           Path(str(lib) + ".log").read_text().splitlines()
                           if "registers" in ln or "spill" in ln]
                    for name, lib in zip(sources, libs)}})

    # ---- phase 2: K1 (and K2 on its stripped rows) vs plain ----
    # seeded random inputs: the operating point first, then the block's
    # other paths: one frame per block, M = 64 and 4096, an odd CP and an
    # unaligned plane (4-byte copies), 4 streams (one-stage block), and
    # 2, 16 and 64 points
    table = constellation.table(Modulation.ARB32OPT)
    main_cmp = None
    for S, M, cp, n_sym, offset, mod in (
            (2, 2048, 152, 1000, 0, Modulation.ARB32OPT),
            (2, 2048, 152, 13, 0, Modulation.ARB32OPT),
            (2, 64, 16, 8, 0, Modulation.ARB32OPT),
            (2, 4096, 288, 40, 0, Modulation.QAM64),
            (2, 2048, 151, 50, 1, Modulation.BPSK),
            (4, 2048, 152, 100, 0, Modulation.QAM16),
            (3, 1024, 72, 30, 2, Modulation.QPSK)):
        rng = np.random.default_rng(M + n_sym)
        sym, tab_c = M + cp, constellation.table(mod)
        buf = torch.as_tensor(rng.standard_normal(
            2 * S * n_sym * sym + offset).astype(np.float32), device=dev)
        p = buf[offset:].view(2, S, n_sym * sym)  # offset: 4-byte copies
        G = ((rng.standard_normal((M, S, S))
              + 1j * rng.standard_normal((M, S, S))) / np.sqrt(2)
             + 2.0 * np.eye(S))  # diagonally dominant: well conditioned
        W, gain = zf.invert(torch.as_tensor(G.astype(np.complex64),
                                            device=dev))
        norm = np.float32(1.0 / np.sqrt(M))
        kw = dict(n_sym=n_sym, symbol_len=sym, cp_len=cp)
        sig, data = pf.payload_fused_strip(p[0], p[1], W, gain, tab_c, norm,
                                           **kw)
        ref_sig, ref_data = pf.payload_tail_reference(
            p[0], p[1], W, gain, tab_c, norm, **kw)
        torch.cuda.synchronize()
        res = compare(sig, data, ref_sig, ref_data, tab_c)
        emit({"phase": "kernel_vs_plain", "S": S, "M": M, "cp": cp,
              "n_sym": n_sym, "plane_offset": offset, "points": len(tab_c),
              **res})
        if main_cmp is None:
            main_cmp = res
        else:  # K2 on the same symbols, CP-stripped
            x = k7.cp_strip_reference(torch.complex(p[0], p[1]), n_sym, sym,
                                      cp)
            res2 = compare(*pf.payload_fused(x, W, gain, tab_c, norm),
                           *pf.payload_fused_reference(x, W, gain, tab_c,
                                                       norm), tab_c)
            emit({"phase": "k2_vs_plain", "S": S, "M": M, "n_sym": n_sym,
                  "points": len(tab_c), **res2})
    # the persistent grids: the operating point, one (4, 1) shard's 263
    # frames, and 4 streams (one-stage blocks)
    geometry = {
        "payload_fused_strip": pf.launch_geometry(
            "payload_fused_strip", 2, 2048, 1000),
        "payload_fused": pf.launch_geometry("payload_fused", 2, 2048, 1000),
        "payload_fused_strip_shard_4x1": pf.launch_geometry(
            "payload_fused_strip", 2, 2048, 263),
        "payload_fused_strip_4_streams": pf.launch_geometry(
            "payload_fused_strip", 4, 2048, 1000)}
    emit({"phase": "k1_k2_geometry", **geometry})

    # ---- the reference operating point's capture ----
    cfg = ModemConfig(pid_max=1000, bit_exact=False)
    spec = simulator.ChannelSpec(snr_db=30.0, delay=5000, seed=42)
    cap, tx_data, _ = simulator.simulate_capture(cfg, spec, device=dev)
    re, im = cap.real.contiguous(), cap.imag.contiguous()
    thr = cfg.plateau_threshold
    S_cap = cap.shape[0]

    # ---- phase 2b: K7, K4, K3, K2 vs plain at the operating point ----
    cases = check_payload_kernels(dev, cfg)
    emit({"phase": "demap_by_modulation", "card": card,
          "shape": list(cases["eq_demap"]["args"][0].shape),
          "geometry": {
              "eq_demap": k34.launch_geometry("eq_demap", 2, cfg.M,
                                              cfg.pid_max),
              "demap": k34.launch_geometry(
                  "demap", 2 * cfg.pid_max * cfg.M, 0)},
          "modulations": demap_by_modulation(dev, cfg, cases)})

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
    # the (4, 1) sharded full-rate stage A's stacked rows on one card, as
    # the path builds them, and one card's rows of it across four cards
    # (odd lengths; shard 0's halo is zeros); stacked_shards, which the
    # scripts use, must build the same rows
    from rub_mimo_tpu_torch.parallel import decode_sharded as ds
    from rub_mimo_tpu_torch.parallel import mesh as pmesh
    mesh41 = pmesh.make_mesh(4, 1, devices=[dev] * 4)
    (_, rows), = ds.stage_a_rows(pmesh.shard_capture(cap, mesh41), mesh41,
                                 cfg.M - 1, "ppermute").values()
    stage_a = rows.reshape(-1, rows.shape[-1])
    require(torch.equal(stacked_shards(cap, 4, cfg.M - 1), stage_a),
            "stacked_shards differs from the sharded stage A's K6 input")
    k6_shapes = {"operating_point": cap, "sharded_stage_a": stage_a,
                 "one_card_share": stage_a[S_cap:2 * S_cap].contiguous()}
    for case in ("sharded_stage_a", "one_card_share"):
        emit({"phase": "k6_vs_plain", "case": case,
              **check_metric(k6_shapes[case], cfg.M, thr)})

    # ---- phase 4: K5 vs plain on eight captures ----
    short = cfg.replace(pid_max=20)  # the widths of cfg, a short payload

    def capture(c, **kw):
        s = simulator.ChannelSpec(**{**dict(snr_db=30.0, seed=42), **kw})
        return simulator.simulate_capture(c, s, device=dev)[0]

    k5_cmp = check_sync("operating_point", cap, cfg)
    x64 = capture(short, delay=64)  # the earliest fire M=2048 allows
    first = check_sync("delay_64", x64, cfg)
    tiny = tiny_config(bit_exact=False)
    first_m64 = check_sync("delay_64_M64", capture(tiny, delay=64), tiny)
    require(first_m64["chunk"] == 0,
            f"no fire in the first chunk: {first_m64}")
    # the same frame and the operating point's, each cut to end 5 samples
    # short of the end of t*'s chunk
    chunk = k5.chunk_len(cfg.M)
    for name, x, fire in (("fire_in_last_chunk", x64, first),
                          ("fire_in_last_chunk_operating_point", cap,
                           k5_cmp)):
        t_end = max(fire["chunk"] * chunk + chunk - 5, fire["t_star"] + 1)
        last = check_sync(name, x[:, :t_end].contiguous(), cfg)
        require(last["synced"] and last["chunk"] == last["last_chunk"],
                f"no fire in the last chunk: {last}")
    none = check_sync("noise_only", noise, cfg)
    require(not none["synced"], "noise-only capture fired")
    zeros = check_sync("leading_zeros_1e5", torch.nn.functional.pad(
        capture(short, delay=300), (100_000, 0)), cfg)
    require(all(r["synced"] for r in (k5_cmp, first, first_m64, zeros)),
            "a capture with a frame did not sync")
    require(k5_cmp["chunks_scanned"] < k5_cmp["chunks"],
            f"the scan did not stop after the fire: {k5_cmp}")
    del noise
    # seeded noise of the operating point's length: K5's whole scan
    rng = np.random.default_rng(8)
    no_fire = torch.as_tensor(
        (rng.standard_normal(cap.shape) + 1j * rng.standard_normal(cap.shape))
        .astype(np.complex64), device=dev)
    k5_none = check_sync("no_fire_operating_length", no_fire, cfg)
    require(not k5_none["synced"]
            and k5_none["chunks_scanned"] == k5_none["chunks"],
            f"the no-fire capture: {k5_none}")

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

    # ---- phase 9b: mimo_2x2_zf under the four payload impls ----
    zcfg, zspec = presets.mimo_2x2_zf()
    zcap, ztx, _ = simulator.simulate_capture(zcfg, zspec, device=dev)
    zplanes = (zcap.real.contiguous(), zcap.imag.contiguous())
    del zcap
    ztab = constellation.table(zcfg.modulation)
    impl_paths = {
        "auto": {"payload_fused_strip": 1},
        "fused": {"cp_strip": 1, "payload_fused": 1},
        "eqdemap": {"cp_strip": 1, "eq_demap": 1},
        "xla": {"cp_strip": 1, "demap": 1},
    }
    impl_dec, impl_counts, impl_res = {}, {}, {}
    for impl, expect in impl_paths.items():
        d = rx.make_decoder(zcfg, device=dev, input_format="planes",
                            payload_impl=impl)
        rz, impl_counts[impl] = run_path(f"mimo_2x2_zf/{impl}", d, zplanes,
                                         ztx, zcfg, expect)
        impl_dec[impl] = d
        impl_res[impl] = rz
        if impl != "auto":
            emit({"phase": "impl_vs_auto", "impl": impl,
                  **same_decode(rz, impl_res["auto"], ztab, impl)})

    # K4 on the input the "xla" path's decode gave it: mismatches only at
    # near-ties; its error is the largest distance between the kernel's
    # and the plain version's decided points
    k4_y = impl_res["xla"].rx_sig.contiguous()
    k4_got = k34.demap(k4_y, ztab)
    k4_ref = constellation.hard_demap(k4_y, ztab)
    k4_cmp = compare(None, k4_got, k4_y, k4_ref, ztab)
    points = torch.as_tensor(ztab.copy(), device=dev)
    k4_cmp["max_abs_err"] = float(
        (points[k4_got.long()] - points[k4_ref.long()]).abs().max())
    emit({"phase": "k4_vs_plain", "case": "mimo_2x2_zf/xla rx_sig",
          "shape": list(k4_y.shape), "points": len(ztab), **k4_cmp})

    # ---- phase 9c: the generic tail's modes at full width ----
    base = dict(pid_max=1000, bit_exact=False)
    spec42 = simulator.ChannelSpec(snr_db=30.0, delay=5000, seed=42)
    gb = ModemConfig(use_all_carriers=False, **base)
    mode_paths = {
        "siso_loopback": presets.siso_loopback(),
        "guard_bands": (gb, spec42),
        "guard_bands_normalized": (gb.replace(normalize_rx_scale=True),
                                   spec42),
        "alamouti_qpsk": (ModemConfig(mode=CommMode.ALAMOUTI,
                                      modulation=Modulation.QPSK, **base),
                          spec42),
        "rx_diversity_qam16": (ModemConfig(mode=CommMode.RX_DIVERSITY,
                                           modulation=Modulation.QAM16,
                                           **base), spec42),
        "sic_qam16": (ModemConfig(detector=Detector.SIC,
                                  modulation=Modulation.QAM16, **base),
                      simulator.ChannelSpec(snr_db=30.0, delay=5000,
                                            seed=3)),
        "ml_qpsk": (ModemConfig(detector=Detector.ML,
                                modulation=Modulation.QPSK, **base), spec42),
        "track_channel": (ModemConfig(track_channel=True,
                                      track_block_frames=8, **base), spec42),
        "track_phase": (ModemConfig(track_phase=True, **base), spec42),
    }
    mode_counts, mode_runs, mode_tx = {}, {}, {}
    for name, (mcfg, mspec) in mode_paths.items():
        mcap, mtx, _ = simulator.simulate_capture(mcfg, mspec, device=dev)
        mplanes = (mcap.real.contiguous(), mcap.imag.contiguous())
        del mcap
        n_demap = {"sic_qam16": mcfg.num_streams + 1,
                   "track_channel": mcfg.pid_max // mcfg.track_block_frames
                   + 1, "track_phase": 2}.get(name, 1)
        d = rx.make_decoder(mcfg, device=dev, input_format="planes")
        rm, mode_counts[name] = run_path(
            name, d, mplanes, mtx, mcfg, {"cp_strip": 1, "demap": n_demap})
        require((rm.Y is not None) == (mcfg.detector == Detector.ML),
                f"{name}: Y kept {rm.Y is not None}")
        mode_runs[name] = (d, mplanes)
        mode_tx[name] = mtx

    # ---- phase 9d: wifi_like at its own width, card vs CPU ----
    wcfg, wspec = presets.wifi_like()
    wcap, wtx, _ = simulator.simulate_capture(wcfg, wspec, device=dev)
    wplanes = (wcap.real.contiguous(), wcap.imag.contiguous())
    wdec = rx.make_decoder(wcfg, device=dev, input_format="planes")
    rw, wcounts = run_path("wifi_like", wdec, wplanes, wtx, wcfg,
                           {"cp_strip": 1, "demap": 1}, ser_zero=False)
    rw_cpu = rx.make_decoder(wcfg, device="cpu")(wcap.cpu())
    rw_card = rw._replace(**{f: getattr(rw, f).cpu() for f in INT_FIELDS})
    wcmp = same_decode(rw_card, rw_cpu, constellation.table(wcfg.modulation),
                       "wifi_like card vs CPU")
    emit({"phase": "wifi_like_card_vs_cpu", "capture": list(wcap.shape),
          "m_occupied": wcfg.M_occupied,
          "ser_percent_card": report.score(rw, wtx, wcfg).symbol_error_rate,
          "ser_percent_cpu": report.score(rw_cpu, wtx,
                                          wcfg).symbol_error_rate,
          "int_fields_equal": True, **wcmp})
    del wcap

    # ---- phase 9e: K8 vs plain, bit for bit ----
    halo = cfg.M - 1
    rng = np.random.default_rng(8)
    for shape in ((2, 1), (4, 1), (8, 1), (4, 2)):
        hmesh = pmesh.make_mesh(*shape, devices=[dev] * (shape[0] * shape[1]))
        parts = [[torch.as_tensor(
            (rng.standard_normal((S, halo)) + 1j * rng.standard_normal(
                (S, halo))).astype(np.complex64), device=dev)
            for _ in range(shape[1])] for _ in range(shape[0])]
        emit({"phase": "k8_vs_plain", "case": "random", "mesh": list(shape),
              "halo": [S, halo], "bit_equal": True,
              "max_abs_err": check_halos(k8, hmesh, parts)})
    # the operating point's own halos: each (4, 1) shard's last M-1 samples
    mesh41 = pmesh.make_mesh(4, 1, devices=[dev] * 4)
    op_halos = [[b[:, -halo:] for b in row]
                for row in pmesh.shard_capture(cap, mesh41)]
    k8_err = check_halos(k8, mesh41, op_halos)
    emit({"phase": "k8_vs_plain", "case": "operating_point", "mesh": [4, 1],
          "halo": [S, halo], "bit_equal": True, "max_abs_err": k8_err})

    # ---- phase 9f: the sharded decode at the operating point ----
    from rub_mimo_tpu_torch.parallel import decode_sharded as ds

    def sharded(c, capture, halo_impl, shape):
        smesh = pmesh.make_mesh(*shape, devices=[dev] * (shape[0] * shape[1]))
        planes_sh = pmesh.shard_capture_planes(capture, smesh)
        d = ds.build_sharded_decoder(
            c, smesh, shape[0] * planes_sh[0][0][0].shape[1],
            halo_impl=halo_impl, input_format="planes")
        return d, planes_sh

    # path -> (halo_impl, mesh, launches; kernels not named: 0)
    shard_paths = {
        "ppermute_4x1": ("ppermute", (4, 1), {"payload_fused_strip": 4}),
        "ppermute_2x2": ("ppermute", (2, 2), {"payload_fused_strip": 4}),
        "pallas_dma_4x1": ("pallas_dma", (4, 1),
                           {"payload_fused_strip": 4, "ring_shift_right": 1,
                            "sc_metric": 1}),
    }
    shard_runs, shard_counts = {}, {}
    for name, (halo_impl, shape, expect) in shard_paths.items():
        d, planes_sh = sharded(cfg, cap, halo_impl, shape)
        rs, counts_s = drive(lambda: d(*planes_sh))
        want = {k: expect.get(k, 0) for k in KERNELS}
        require(counts_s == want,
                f"sharded {name}: launches {counts_s}, expected {want}")
        scmp = same_sharded(rs, r, tab, f"sharded {name}")
        ser = stream_ser(rs.rx_data, tx_data, cfg)
        require(all(x == 0.0 for x in ser), f"sharded {name}: SER {ser}")
        emit({"phase": "sharded", "path": name, "mesh": list(shape),
              "halo_impl": halo_impl,
              "shard": list(planes_sh[0][0][0].shape), "launches": counts_s,
              "ser_percent": ser, "equal_to_single_device": True, **scmp})
        shard_runs[name], shard_counts[name] = (d, planes_sh), counts_s
        del rs

    # ---- phase 9g: mimo_4x4_wideband at full width, single and sharded --
    qcfg, qspec = presets.mimo_4x4_wideband()
    qcap, qtx, _ = simulator.simulate_capture(qcfg, qspec, device=dev)
    qplanes = (qcap.real.contiguous(), qcap.imag.contiguous())
    qdec = rx.make_decoder(qcfg, device=dev, input_format="planes")
    rq, q_counts = drive(lambda: qdec(*qplanes))
    qsd, q_sh = sharded(qcfg, qcap, "ppermute", (4, 1))
    rqs, qs_counts = drive(lambda: qsd(*q_sh))
    # sync_quorum=3 takes the full-rate stage A (K6 once, its halo by the
    # ppermute collective) and K1 runs on each shard
    want = {k: {"payload_fused_strip": 4, "sc_metric": 1}.get(k, 0)
            for k in KERNELS}
    require(qs_counts == want,
            f"mimo_4x4_wideband sharded: launches {qs_counts}, "
            f"expected {want}")
    qcmp = same_sharded(rqs, rq, constellation.table(qcfg.modulation),
                        "mimo_4x4_wideband sharded")
    emit({"phase": "mimo_4x4_wideband", "capture": list(qplanes[0].shape),
          "sync_quorum": qcfg.sync_quorum, "detector": qcfg.detector.name,
          "launches_single": q_counts, "launches_sharded_4x1": qs_counts,
          "synced": bool(rq.synced), "sync_index": int(rq.sync_index),
          "ser_percent_single": report.score(rq, qtx, qcfg).symbol_error_rate,
          "ser_percent_sharded": stream_ser(rqs.rx_data, qtx, qcfg),
          "equal_to_single_device": True, **qcmp})
    del rqs

    # ---- phase 9h: across cards (2 or more cards) ----
    xc = across_cards(cfg, cap, tx_data, r, qcfg, qcap, qtx, rq)
    del qcap, rq

    # ---- phase 9i: serving from CUDA graphs ----
    # the operating point on the serving seeds, eight captures as planes
    # (each capture's decode replayed from one graph: K5, then K1), then
    # the CFO config (K5 with the S0 fallback, K1), mimo_2x2_zf "xla"
    # (K5, K7, K4), track_channel (K5, K7, K4 per block) and
    # mimo_4x4_wideband with the full-rate sync (K6, K1; K5 refuses a
    # sync_quorum), one capture each, beside their eager decodes
    serve_caps, serve_tx = [], []
    for seed in SERVING_SEEDS:
        c, t_x, _ = simulator.simulate_capture(
            cfg, simulator.ChannelSpec(snr_db=30.0, delay=5000, seed=seed),
            device=dev)
        serve_caps.append(c)
        serve_tx.append(t_x)
    stack = torch.stack(serve_caps)
    serve_planes = (stack.real.contiguous(), stack.imag.contiguous())
    del serve_caps, stack
    track = mode_paths["track_channel"][0]
    trk_planes = mode_runs["track_channel"][1]

    def eager(c, **kw):
        return rx.make_decoder(c, device=dev, input_format="planes", **kw)

    def one(planes):
        return tuple(p[None] for p in planes)

    pallas_xla = dict(sync_impl="pallas", payload_impl="xla")
    served = {
        "operating_point": serve_path(
            "operating_point", cfg, serve_planes, serve_tx,
            dict(sync_impl="pallas"),
            {"sc_sync": 1, "payload_fused_strip": 1},
            {"eager_sync_pallas": dec_pallas, "eager_default": dec}),
        "cfo_config": serve_path(
            "cfo_config", cfg_cfo, one((re_c, im_c)), [tx_c],
            dict(sync_impl="pallas"),
            {"sc_sync": 1, "payload_fused_strip": 1},
            {"eager_sync_pallas": eager(cfg_cfo, sync_impl="pallas"),
             "eager_default": dec_cfo}),
        "mimo_2x2_zf_xla": serve_path(
            "mimo_2x2_zf_xla", zcfg, one(zplanes), [ztx], pallas_xla,
            {"sc_sync": 1, "cp_strip": 1, "demap": 1},
            {"eager_sync_pallas": eager(zcfg, **pallas_xla),
             "eager_default": impl_dec["xla"]}),
        "track_channel": serve_path(
            "track_channel", track, one(trk_planes),
            [mode_tx["track_channel"]], dict(sync_impl="pallas"),
            {"sc_sync": 1, "cp_strip": 1,
             "demap": track.pid_max // track.track_block_frames + 1},
            {"eager_sync_pallas": eager(track, sync_impl="pallas"),
             "eager_default": mode_runs["track_channel"][0]}),
        "mimo_4x4_wideband": serve_path(
            "mimo_4x4_wideband", qcfg, one(qplanes), [qtx],
            dict(sync_impl="xla"),
            {"sc_metric": 1, "payload_fused_strip": 1},
            {"eager_sync_xla": eager(qcfg, sync_impl="xla"),
             "eager_default": qdec}),
    }

    # ---- phase 9j: the served paths read nothing back ----
    no_host_sync({
        "operating_point": (dec_pallas, (serve_planes[0][0],
                                         serve_planes[1][0])),
        "cfo_config": (eager(cfg_cfo, sync_impl="pallas"), (re_c, im_c)),
        "mimo_2x2_zf_xla": (eager(zcfg, **pallas_xla), zplanes),
        "track_channel": (eager(track, sync_impl="pallas"), trk_planes),
        "mimo_4x4_wideband": (eager(qcfg, sync_impl="xla"), qplanes)})
    del serve_planes

    # ---- phase 9k: decode_all on two bursts and on one ----
    burst_spec = simulator.ChannelSpec(snr_db=35.0, delay=0, trailing=0,
                                       seed=5)
    cap2, data2 = two_bursts(cfg, dev, burst_spec)
    kept = cap2.clone()
    bursts = rx.decode_all(cap2, cfg, device=dev, max_bursts=4)
    require(torch.equal(cap2, kept), "decode_all modified its input")
    require(len(bursts) == 2, f"decode_all found {len(bursts)} bursts of 2")
    require(int(bursts[1].sync_index) > int(bursts[0].sync_index),
            "decode_all: the second burst is not after the first")
    burst_ser = [stream_ser(b.rx_data, d, cfg) for b, d in zip(bursts, data2)]
    require(all(x == 0.0 for sr in burst_ser for x in sr),
            f"decode_all: SER {burst_ser}")
    single = rx.decode_all(cap, cfg, device=dev, max_bursts=4)
    require(len(single) == 1, f"decode_all found {len(single)} bursts of 1")
    emit({"phase": "decode_all", "capture": list(cap2.shape),
          "bursts": len(bursts),
          "sync_index": [int(b.sync_index) for b in bursts],
          "ser_percent": burst_ser, "input_unchanged": True,
          "one_burst_capture": {"capture": list(cap.shape),
                                "bursts": len(single)},
          "ms": cuda_ms(lambda: rx.decode_all(cap2, cfg, device=dev),
                        iters=3, warmup=1)})
    del cap2, kept, bursts, single

    # ---- phase 10: times (CUDA events, medians over TIMING_ITERS) ----
    # the two sync paths in turns: default, pallas, pallas, default
    t_dec = cuda_ms(lambda: dec(re, im))
    t_pal = cuda_ms(lambda: dec_pallas(re, im))
    t_pal2 = cuda_ms(lambda: dec_pallas(re, im))
    t_dec2 = cuda_ms(lambda: dec(re, im))
    t_cfo = cuda_ms(lambda: dec_cfo(re_c, im_c))
    t_debug = cuda_ms(lambda: dec_debug(re, im), iters=MODE_ITERS)
    t_impl = {impl: cuda_ms(lambda d=d: d(*zplanes), iters=MODE_ITERS)
              for impl, d in impl_dec.items()}
    t_mode = {name: cuda_ms(lambda d=d, p=p: d(*p), iters=MODE_ITERS)
              for name, (d, p) in mode_runs.items()}
    t_wifi = cuda_ms(lambda: wdec(*wplanes), iters=MODE_ITERS)
    t_shard = {name: cuda_ms(lambda d=d, p=p: d(*p), iters=MODE_ITERS)
               for name, (d, p) in shard_runs.items()}
    t_4x4 = {"single": cuda_ms(lambda: qdec(*qplanes), iters=MODE_ITERS),
             "sharded_4x1": cuda_ms(lambda: qsd(*q_sh), iters=MODE_ITERS)}
    t_across = None
    if xc is not None:
        # CUDA events on the home card (cuda:0), where every result lands;
        # the (n, 1) pair and the two servings in turns: a, b, b, a
        nt = xc["n_time"]
        order = [f"pallas_dma_{nt}x1", f"ppermute_{nt}x1"]
        order += [k for k in xc["runs"] if k not in order]
        t_across = {"decode_sharded": {}, "decode_sharded_again": {},
                    "serving_8": {}, "serving_8_again": {}}
        for rnd, seq in (("decode_sharded", order),
                         ("decode_sharded_again", order[1::-1])):
            for name in seq:
                d, p = xc["runs"][name]
                t_across[rnd][name] = cuda_ms(lambda d=d, p=p: d(*p),
                                              iters=MODE_ITERS)
        for rnd, seq in (("serving_8", ("cards", "one_card")),
                         ("serving_8_again", ("one_card", "cards"))):
            for key in seq:
                d, b = xc["serve"][key]
                t_across[rnd][key] = cuda_ms(lambda d=d, b=b: d(b),
                                             iters=MODE_ITERS)
        t_across["ring_shift_right_peer"] = cuda_ms(
            lambda: k8.ring_shift_right(xc["k8"][1], xc["k8"][0]))
    # each kernel, its plain version and, where there is one, the one
    # PyTorch call computing the same function, on the main path's shapes
    sync_args = (cap, cfg.M, cfg.cp_len, thr)
    k4_args = (k4_y, ztab)  # the xla path's K4 input
    k7p, _, k7sym, k7cp = k7_args = cases["cp_strip"]["args"]
    op_stack = torch.stack([row[0] for row in op_halos])  # [4, S, M-1]
    calls = {
        "payload_fused_strip": (
            lambda: pf.payload_fused_strip(p_re, p_im, r.W, r.normalize_gain,
                                           tab, norm, **kw),
            lambda: pf.payload_tail_reference(
                p_re, p_im, r.W, r.normalize_gain, tab, norm, **kw), None),
        "payload_fused": (
            lambda: pf.payload_fused(*cases["payload_fused"]["args"]),
            lambda: pf.payload_fused_reference(
                *cases["payload_fused"]["args"]), None),
        "eq_demap": (
            lambda: k34.eq_demap(*cases["eq_demap"]["args"]),
            lambda: k34.eq_demap_reference(*cases["eq_demap"]["args"]),
            None),
        "demap": (lambda: k34.demap(*k4_args),
                  lambda: constellation.hard_demap(*k4_args), None),
        "sc_sync": (lambda: k5.sc_sync_fused(*sync_args),
                    lambda: k5.sc_sync_reference(*sync_args), None),
        "sc_metric": (lambda: k6.sc_metric_fused(cap, cfg.M),
                      lambda: k6.sc_metric_reference(cap, cfg.M), None),
        "cp_strip": (
            lambda: k7.cp_strip(*k7_args),
            lambda: k7.cp_strip_reference(*k7_args),
            lambda: k7p.view(S, n_sym, k7sym)[:, :, k7cp:].contiguous()),
        # the same exchange as one PyTorch call on the stacked halos
        "ring_shift_right": (
            lambda: k8.ring_shift_right(op_halos, mesh41),
            lambda: k8.ring_shift_right_reference(op_halos, mesh41),
            lambda: torch.nn.functional.pad(op_stack[:-1],
                                            (0, 0, 0, 0, 1, 0))),
    }
    # CUDA events around single calls: the kernel plus the host's launch
    # work, which is the larger part for the short kernels
    t_calls = {name: tuple(None if f is None else cuda_ms(f) for f in fns)
               for name, fns in calls.items()}
    t_k1, t_plain = t_calls["payload_fused_strip"][:2]
    t_k5, t_k5_plain = t_calls["sc_sync"][:2]
    t_k6, t_k6_plain = t_calls["sc_metric"][:2]
    emit({"phase": "times", "card": card, "iters": TIMING_ITERS,
          "mode_iters": MODE_ITERS,
          "decode": t_dec, "decode_sync_pallas": t_pal,
          "decode_sync_pallas_again": t_pal2, "decode_again": t_dec2,
          "decode_cfo_config": t_cfo, "decode_keep_debug": t_debug,
          "decode_mimo_2x2_zf": t_impl, "decode_mode": t_mode,
          "decode_wifi_like": t_wifi,
          "decode_sharded": t_shard, "decode_mimo_4x4_wideband": t_4x4,
          "across_cards": t_across,
          "k1": t_k1, "plain_tail": t_plain,
          "k5": t_k5, "plain_k5": t_k5_plain,
          "k6": t_k6, "plain_k6": t_k6_plain,
          **{name: {"kernel": k, "plain": p, "library": lib}
             for name, (k, p, lib) in t_calls.items()
             if name in ("cp_strip", "demap", "eq_demap", "payload_fused",
                         "ring_shift_right")},
          "decode_samples_per_s": S * T / (t_dec["median_ms"] * 1e-3)})

    # ---- phase 11: where the decode's time goes ----
    # stage times before the profiler sessions: the host's launches run
    # slower after them, as the decode timed again afterwards shows
    stage_ms = stage_times(cfg, re, im, int(r.sync_index))
    busy = device_busy(lambda: dec(re, im))
    busy_pal = device_busy(lambda: dec_pallas(re, im))
    busy_xla = device_busy(lambda: impl_dec["xla"](*zplanes))
    busy_shard = {name: device_busy(lambda d=d, p=p: d(*p))
                  for name, (d, p) in shard_runs.items()
                  if name.endswith("4x1")}
    busy_across = {} if xc is None else {
        name: device_busy(lambda d=d, p=p: d(*p))
        for name, (d, p) in xc["runs"].items() if name.endswith("x1")}
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
              "longest_kernels_us": busy_pal["top_kernels_us"]},
          "mimo_2x2_zf_xla": {
              "device_busy_ms_per_decode": busy_xla["busy_ms"],
              "device_idle_share": (
                  None if busy_xla["busy_ms"] is None else
                  1.0 - busy_xla["busy_ms"]
                  / t_impl["xla"]["median_ms"]),
              "device_kernels_per_decode": busy_xla["kernels"],
              "longest_kernels_us": busy_xla["top_kernels_us"]},
          "sharded": {name: {
              "device_busy_ms_per_decode": b["busy_ms"],
              "device_idle_share": (
                  None if b["busy_ms"] is None else
                  1.0 - b["busy_ms"] / t_shard[name]["median_ms"]),
              "device_kernels_per_decode": b["kernels"],
              "longest_kernels_us": b["top_kernels_us"]}
              for name, b in busy_shard.items()},
          # across cards: busy while any card is, and each card's own
          "across_cards": {name: {
              "device_busy_ms_per_decode": b["busy_ms"],
              "busy_ms_by_card": b["busy_ms_by_card"],
              "device_idle_share": (
                  None if b["busy_ms"] is None else 1.0 - b["busy_ms"]
                  / t_across["decode_sharded"][name]["median_ms"]),
              "device_kernels_per_decode": b["kernels"],
              "longest_kernels_us": b["top_kernels_us"]}
              for name, b in busy_across.items()}})

    # ---- phase 12: each kernel's time on the card (torch.profiler) ----
    # the card's busy time per call, kernel work only; CUDA events (which
    # add the host's launch work) stand in where the profiler records no
    # device activity, and "timer" says which one each time is
    dev_ms, timer, prof = {}, {}, {}
    for name, fns in calls.items():
        prof[name] = [None if f is None else device_busy(f, n=10)
                      for f in fns]
        busy = [None if p is None else p["busy_ms"] for p in prof[name]]
        timer[name] = ["profiler" if b is not None else
                       None if f is None else "cuda_events"
                       for f, b in zip(fns, busy)]
        dev_ms[name] = tuple(
            b if b is not None else None if ev is None else ev["median_ms"]
            for b, ev in zip(busy, t_calls[name]))
    k8_peer = None
    if xc is not None:
        # K8's peer form: the device time of each launch by card (card 0's
        # launch only writes zeros, the others pull a halo over NVLink),
        # against the bound of one launch: a pull reads one [S, M-1]
        # halo over NVLink and writes it to HBM, the larger of the two
        # times; a zero fill writes it
        halo_bytes = nbytes(xc["k8"][1][0][0])
        k8_peer = {
            "mesh": [xc["n_time"], 1],
            "plain_ms": cuda_ms(lambda: k8.ring_shift_right_reference(
                xc["k8"][1], xc["k8"][0]))["median_ms"],
            "halo_bytes": halo_bytes,
            "bound_pull_ms": max(halo_bytes / NVLINK_BYTES_PER_S,
                                 halo_bytes / HBM_BYTES_PER_S) * 1e3,
            "bound_zero_fill_ms": halo_bytes / HBM_BYTES_PER_S * 1e3,
            "bound_by": "bytes",
            **launch_device_us(lambda: k8.ring_shift_right(
                xc["k8"][1], xc["k8"][0]), "ring_shift_right")}
    # K5 kernel by kernel (its scan, its resolve and the memset of its
    # counters) over the same 10 calls as its row, at the operating point
    # (the fire at t* = 7,147 stops the scan), and on the no-fire capture
    # (the whole scan)
    k5_split = {}
    for case, p, chk in (
            ("operating_point", prof["sc_sync"][0], k5_cmp),
            ("no_fire", device_busy(lambda: k5.sc_sync_fused(
                no_fire, cfg.M, cfg.cp_len, thr), n=10), k5_none)):
        k5_split[case] = {
            key: p[key] for key in ("busy_ms", "busy_ms_median",
                                    "kernels_us")} | {
            key: chk[key] for key in ("chunks", "chunks_scanned")}
    k5_geometry = k5.scan_geometry(S, T, M)
    # K6 at the three shapes its paths give it (the full-rate scan, the
    # one-card sharded stage A, one card's share across cards), each
    # beside its persistent grid
    k6_split = {}
    for case, xk in k6_shapes.items():
        p = prof["sc_metric"][0] if case == "operating_point" else \
            device_busy(lambda xk=xk: k6.sc_metric_fused(xk, M), n=10)
        b = bound(nbytes(xk) + 4 * xk.numel(), 18.0 * xk.numel())
        k6_split[case] = {
            "shape": list(xk.shape), "ms": p["busy_ms"],
            "ms_median": p["busy_ms_median"],
            "bound_ms": b["bound_ms"],
            "bound_share": (None if p["busy_ms"] is None
                            else b["bound_ms"] / p["busy_ms"]),
            "geometry": k6.metric_geometry(*xk.shape, M)}
    # K4 as track_channel launches it: one 8-frame block, [S, 8, M]
    # symbols over the operating point's 32 points
    rng = np.random.default_rng(126)
    y_trk = torch.as_tensor(
        ((rng.standard_normal((S, 8, M)) + 1j * rng.standard_normal(
            (S, 8, M))) * 0.8).astype(np.complex64), device=dev)
    trk_cmp = compare(None, k34.demap(y_trk, tab), y_trk,
                      constellation.hard_demap(y_trk, tab), tab)
    k4_track = {"shape": list(y_trk.shape), "points": len(tab),
                "ms": device_busy(lambda: k34.demap(y_trk, tab),
                                  n=10)["busy_ms"],
                "event_ms": cuda_ms(lambda: k34.demap(
                    y_trk, tab))["median_ms"],
                "mismatches": trk_cmp["mismatches"],
                **bound(y_trk.numel() * (8 + 4),
                        4.0 * len(tab) * y_trk.numel())}
    emit({"phase": "kernel_device_ms", "card": card, "profiled_calls": 10,
          **{name: {"kernel": k, "plain": p, "library": lib,
                    "timer": timer[name]}
             for name, (k, p, lib) in dev_ms.items()},
          "sc_sync_split": k5_split, "sc_sync_geometry": k5_geometry,
          "sc_metric_shapes": k6_split,
          "sc_metric_before_quoted": K6_BEFORE_QUOTED,
          "demap_tracking_block": k4_track,
          "ring_shift_right_peer": k8_peer})

    # ---- phase 12b: each payload_impl's whole tail on the card ----
    # from the planes' payload slice to the decisions, on the operating
    # point's capture and weights, as decode runs it under each impl
    def strip():
        return rx.strip_payload(None, (re, im), cstart, cfg)

    W_op, g_op = r.W, r.normalize_gain
    tails = {
        "auto": lambda: pf.payload_fused_strip(
            *(rx.extract_payload(p, cstart, n_sym * sym) for p in (re, im)),
            W_op, g_op, tab, norm, **kw),
        "fused": lambda: pf.payload_fused(strip(), W_op, g_op, tab, norm),
        "eqdemap": lambda: k34.eq_demap(
            torch.fft.fft(strip(), dim=-1) * float(norm), W_op, g_op, tab),
        "xla": lambda: rx.payload_tail(strip(), r.G, W_op, g_op, cfg),
    }
    emit({"phase": "tail_device_ms", "card": card, "profiled_calls": 10,
          **{impl: {"device_busy_ms": device_busy(f, n=10)["busy_ms"],
                    "event_ms": cuda_ms(f)["median_ms"]}
             for impl, f in tails.items()}})

    # the payload window at a device start (the decode's gather: one
    # index for both planes) against the copy at host ints it replaced,
    # on the operating point's planes and start
    cstart_dev = (torch.clamp(r.sync_index, 0, T) + r.decode_start - sym)
    plen = n_sym * sym

    def window_gather():
        win = rx.window_index(cstart_dev, plen, T, dev)
        return [rx.gather_window(p, *win) for p in (re, im)]

    def window_copy():
        lo = min(max(-cstart, 0), plen)
        hi = max(min(T - cstart, plen), lo)
        outs = []
        for p in (re, im):
            o = torch.empty((S, plen), dtype=p.dtype, device=dev)
            o[:, :lo] = 0
            o[:, lo:hi] = p[:, cstart + lo:cstart + hi]
            o[:, hi:] = 0
            outs.append(o)
        return outs

    require(all(torch.equal(a, b) for a, b in zip(window_gather(),
                                                   window_copy())),
            "the payload window's gather differs from its copy")
    gather_us, copy_us = profiled_us(window_gather), profiled_us(window_copy)
    emit({"phase": "payload_window", "card": card, "planes": [2, S, plen],
          "gather_device_us": gather_us, "copy_device_us": copy_us,
          "gather_minus_copy_us": gather_us - copy_us,
          "gather_event_ms": cuda_ms(window_gather)["median_ms"],
          "copy_event_ms": cuda_ms(window_copy)["median_ms"]})

    # ---- phase 12c: K1 and K2 warm and cold, and K1 on one shard ----
    # CUDA events around single calls, cold after a 256 MB write evicts
    # the L2; K1 also at one (4, 1) shard's call: 263 frames of the
    # operating point's pitch (the sharded stage C's shape)
    junk = torch.empty(L2_FLUSH_BYTES // 4, dtype=torch.float32, device=dev)

    def flush():
        junk.fill_(1.0)

    t_loc = -(-T // (4 * 128)) * 128  # one (4, 1) shard's samples
    n_shard = -(-t_loc // sym) + 1     # the symbol slots it can own
    rng = np.random.default_rng(263)
    p_sh = torch.as_tensor(rng.standard_normal(
        (2, S, n_shard * sym)).astype(np.float32), device=dev)
    kw_sh = dict(n_sym=n_shard, symbol_len=sym, cp_len=cfg.cp_len)

    def k1_shard():
        return pf.payload_fused_strip(p_sh[0], p_sh[1], r.W, r.normalize_gain,
                                      tab, norm, **kw_sh)

    sh_cmp = compare(*k1_shard(), *pf.payload_tail_reference(
        p_sh[0], p_sh[1], r.W, r.normalize_gain, tab, norm, **kw_sh), tab)
    k12 = {
        "payload_fused_strip": {
            "warm_ms": event_ms(calls["payload_fused_strip"][0]),
            "cold_l2_ms": event_ms(calls["payload_fused_strip"][0], flush)},
        "payload_fused": {
            "warm_ms": event_ms(calls["payload_fused"][0]),
            "cold_l2_ms": event_ms(calls["payload_fused"][0], flush)},
        "payload_fused_strip_shard_4x1": {
            "n_sym": n_shard, "warm_ms": event_ms(k1_shard),
            "cold_l2_ms": event_ms(k1_shard, flush),
            "device_ms": device_busy(k1_shard, n=10)["busy_ms"],
            "mismatches": sh_cmp["mismatches"],
            "rel_err": sh_cmp["rel_err"]}}
    del junk
    # the demap's cost per point: K1 on the operating point's payload
    # with 2 to 64 points (the decisions held to the plain version's),
    # and the SM clock while K1 runs back to back
    sweep = {}
    for mod in (Modulation.BPSK, Modulation.QPSK, Modulation.QAM16,
                Modulation.ARB32OPT, Modulation.QAM64):
        tab_m = constellation.table(mod)

        def k1_mod(tab_m=tab_m):
            return pf.payload_fused_strip(p_re, p_im, r.W, r.normalize_gain,
                                          tab_m, norm, **kw)

        m_cmp = compare(*k1_mod(), *pf.payload_tail_reference(
            p_re, p_im, r.W, r.normalize_gain, tab_m, norm, **kw), tab_m)
        sweep[mod.name] = {"points": len(tab_m), "warm_ms": event_ms(k1_mod),
                           "mismatches": m_cmp["mismatches"]}
    k12["payload_fused_strip_by_modulation"] = sweep
    k12["payload_fused_strip_clocks"] = clocks_under_load(
        calls["payload_fused_strip"][0])
    emit({"phase": "k1_k2_times", "card": card, "iters": TIMING_ITERS,
          "l2_flush_bytes": L2_FLUSH_BYTES, "geometry": geometry, **k12})

    # ---- phase 12: the streaming decoder at full width ----
    streamed = streaming_phase(dev, card, cfg, cap, tx_data, r, cfg_cfo,
                               torch.complex(re_c, im_c), tx_c, rc, p_re,
                               p_im)

    # ---- phase 13: the coded chain, the LLR and Viterbi kernels, SFO ----
    coded = coded_phase(dev, card, cfg)
    llr = soft_llr_check(dev, card, coded["sig"], cfg)
    llr_rows = soft_llr_rows_check(dev, card, coded["sig"], cfg)
    vit = viterbi_check(dev, card, coded["rows"])
    del coded["rows"], coded["sig"]
    sfo_phase(dev, card)
    streaming_sfo_phase(dev, card)

    # ---- phase 14: the command line (apps/cli.py) and what it drives ----
    cli_phase(dev, card)

    # ---- phase 15: the sharded decode across processes ----
    mproc = multiprocess_phase(card, shard_runs, xc)

    # ---- phase 16: live_view, analyze (and report_html) ----
    apps_phase(dev, card, cfg, cap, tx_data)

    # ---- the kernels line: bounds from this run's inputs ----
    K_op = len(tab)
    x2, W2, g2, _, _ = cases["payload_fused"]["args"]
    X3, W3, g3, _ = cases["eq_demap"]["args"]
    out_sig_data = S * n_sym * M * (8 + 4)
    # K1 and K7 read only the M kept samples of each symbol: the CP's
    # whole 32-byte sectors never leave memory
    k1_read = 2 * S * n_sym * M * p_re.element_size()
    k7_read = S * n_sym * (k7sym - k7cp) * k7p.element_size()
    bounds = {
        "payload_fused_strip": bound(
            k1_read + nbytes(r.W, r.normalize_gain) + out_sig_data,
            tail_flops(S, n_sym, M, K_op, fft=True)),
        "payload_fused": bound(nbytes(x2, W2, g2) + out_sig_data,
                               tail_flops(S, n_sym, M, K_op, fft=True)),
        "eq_demap": bound(nbytes(X3, W3, g3) + out_sig_data,
                          tail_flops(S, n_sym, M, K_op, fft=False)),
        "demap": bound(k4_y.numel() * (8 + 4),
                       4.0 * len(ztab) * k4_y.numel()),
        # the S&C metric, ~18 operations per sample and stream, on the
        # samples up to t* (the capture when nothing fires)
        "sc_sync": bound(S * (k5_cmp["t_star"] + 1) * cap.element_size(),
                         18.0 * S * (k5_cmp["t_star"] + 1)),
        "sc_metric": bound(nbytes(cap) + 4 * cap.numel(),
                           18.0 * cap.numel()),
        "cp_strip": bound(2 * k7_read, 0.0),
        # K8 reads the halos of shards 0..2 and writes all four
        "ring_shift_right": bound(
            nbytes(op_stack[:-1], op_stack), 0.0),
        "viterbi": vit["bound"],
        "soft_llr": llr["bound"],
        "soft_llr_rows": llr_rows["bound"],
    }
    launched = {
        "payload_fused_strip": launches,
        "payload_fused": impl_counts["fused"]["payload_fused"],
        "eq_demap": impl_counts["eqdemap"]["eq_demap"],
        "demap": impl_counts["xla"]["demap"],
        "sc_sync": counts_pallas["sc_sync"],
        "sc_metric": counts_debug["sc_metric"],
        "cp_strip": impl_counts["fused"]["cp_strip"],
        "ring_shift_right": shard_counts["pallas_dma_4x1"]["ring_shift_right"],
        "viterbi": coded["counts"]["viterbi"],
        "soft_llr": coded["llr_counts"]["soft_llr"],
        "soft_llr_rows": coded["counts"]["soft_llr_rows"],
    }
    errors = {
        "payload_fused_strip": main_cmp["max_abs_err"],
        "payload_fused": cases["payload_fused"]["max_abs_err"],
        "eq_demap": cases["eq_demap"]["max_abs_err"],
        "demap": k4_cmp["max_abs_err"],
        "sc_sync": k5_cmp["corr_abs_err"],
        "sc_metric": k6_cmp["max_abs_err"],
        "cp_strip": cases["cp_strip"]["max_abs_err"],
        "ring_shift_right": k8_err,
        "viterbi": vit["max_abs_err"],
        "soft_llr": llr["max_abs_err"],
        "soft_llr_rows": llr_rows["max_abs_err"],
    }
    no_fire_bound = bound(nbytes(no_fire), 18.0 * no_fire.numel())
    # K4's integer decisions: its mismatches and their largest top-2 margin
    k1_shard_bound = bound(
        2 * S * n_shard * M * 4 + nbytes(r.W, r.normalize_gain)
        + S * n_shard * M * (8 + 4),
        tail_flops(S, n_shard, M, K_op, fft=True))["bound_ms"]
    extra = {"payload_fused_strip": {
                 "cold_l2_ms": k12["payload_fused_strip"]["cold_l2_ms"],
                 "warm_event_ms": k12["payload_fused_strip"]["warm_ms"],
                 "shard_4x1_ms": k12["payload_fused_strip_shard_4x1"][
                     "device_ms"],
                 "shard_4x1_bound_ms": k1_shard_bound,
                 "grid": geometry["payload_fused_strip"]["grid"],
                 "blocks_per_sm": geometry["payload_fused_strip"][
                     "blocks_per_sm"]},
             "payload_fused": {
                 "cold_l2_ms": k12["payload_fused"]["cold_l2_ms"],
                 "warm_event_ms": k12["payload_fused"]["warm_ms"],
                 "grid": geometry["payload_fused"]["grid"],
                 "blocks_per_sm": geometry["payload_fused"]["blocks_per_sm"]},
             "sc_sync": {
                 "no_fire": {
                     "ms": k5_split["no_fire"]["busy_ms"],
                     "bound_ms": no_fire_bound["bound_ms"],
                     "bound_share": (
                         None if k5_split["no_fire"]["busy_ms"] is None
                         else no_fire_bound["bound_ms"]
                         / k5_split["no_fire"]["busy_ms"])},
                 "t_star": k5_cmp["t_star"],
                 "kernels_us": k5_split["operating_point"]["kernels_us"],
                 "kernels_us_no_fire": k5_split["no_fire"]["kernels_us"],
                 "chunks": k5_split["operating_point"]["chunks"],
                 "chunks_scanned": k5_split["operating_point"][
                     "chunks_scanned"],
                 "chunks_scanned_no_fire": k5_split["no_fire"][
                     "chunks_scanned"],
                 "grid": k5_geometry["grid"],
                 "blocks_per_sm": k5_geometry["blocks_per_sm"]},
             "demap": {"mismatches": k4_cmp["mismatches"],
                       "max_mismatch_margin": max(
                           k4_cmp["mismatch_margins"], default=0.0),
                       "tracking_block": {
                           key: k4_track[key] for key in (
                               "shape", "ms", "event_ms", "bound_ms")}},
             "sc_metric": {
                 "shapes": {case: {key: v[key] for key in (
                     "shape", "ms", "bound_ms", "bound_share")}
                     for case, v in k6_split.items()},
                 "grid": k6_split["operating_point"]["geometry"]["grid"],
                 "blocks_per_sm": k6_split["operating_point"]["geometry"][
                     "blocks_per_sm"],
                 "chunk": k6_split["operating_point"]["geometry"]["chunk"]},
             "ring_shift_right": {
                 "note": "bound well under 1 us: its time is launch latency",
                 "launches_per_multiprocess_decode": mproc[
                     "one_card_gloo/pallas_dma"]["launches_per_rank"][0][
                     "ring_shift_right"],
                 "multiprocess": {
                     key: {"kernel_us_by_rank": [
                         k["kernel_us"] for k in v["k8_by_rank"]],
                         "exchange_wall_ms_by_rank": [
                             k["exchange_wall_ms_median"]
                             for k in v["k8_by_rank"]],
                         "launch_ms_by_rank": v["k8_launch_ms_by_rank"],
                         "split_us_by_rank": v["k8_split_us_by_rank"],
                         "host_syncs_per_call": v["k8_host_syncs_per_call"],
                         "launches_per_call": v["k8_launches_per_call"],
                         "bound_ms_by_rank": [
                             k8_rank_bound(k) for k in v["k8_by_rank"]]}
                     for key, v in mproc.items()
                     if v["halo_impl"] == "pallas_dma"}},
             "viterbi": {
                 "tpu_kernel": None,
                 "note": "replaces the JAX package's lax.scan pair",
                 "timer": vit["timer"],
                 "launches_per_coded_decode": coded["counts"]["viterbi"],
                 "codeword_16390_event_ms": vit["codeword_16390_ms"],
                 "cases": vit["cases"]},
             "soft_llr": {
                 "tpu_kernel": None,
                 "note": "replaces the JAX package's XLA ops; the rows "
                         "kernel's source with the identity geometry",
                 "timer": llr["timer"],
                 "event_ms": llr["event_ms"],
                 "launches_per_soft_demodulate_llr": coded["llr_counts"][
                     "soft_llr"],
                 "launches_per_coded_decode": coded["counts"]["soft_llr"],
                 "bytes_bound_ms": llr["bound"]["bytes_bound_ms"],
                 "operations_bound_ms": llr["bound"]["operations_bound_ms"],
                 "cases": llr["cases"]},
             "soft_llr_rows": {
                 "tpu_kernel": None,
                 "note": "replaces the JAX package's XLA ops: the LLRs, "
                         "the deinterleave, the depuncture and the "
                         "Viterbi's window pads, one launch",
                 "timer": llr_rows["timer"],
                 "event_ms": llr_rows["event_ms"],
                 "launches_per_coded_decode": coded["counts"][
                     "soft_llr_rows"],
                 "bytes_bound_ms": llr_rows["bound"]["bytes_bound_ms"],
                 "operations_bound_ms": llr_rows["bound"][
                     "operations_bound_ms"],
                 "cases": llr_rows["cases"]}}
    dev_ms["viterbi"] = (vit["ms"], vit["plain_ms"], None)
    dev_ms["soft_llr"] = (llr["ms"], llr["plain_ms"], None)
    dev_ms["soft_llr_rows"] = (llr_rows["ms"], llr_rows["plain_ms"], None)
    # launches of each kernel in one replay of each served path's graph
    for name in KERNELS:
        per = {path: v["launches_per_replay"][name]
               for path, v in served.items()
               if v["launches_per_replay"][name]}
        if per:
            extra.setdefault(name, {})["launches_per_served_capture"] = per
    # launches of each kernel in one streamed capture, by streamed path
    for name, per in streamed["launches"].items():
        extra.setdefault(name, {})["launches_per_streamed_capture"] = per
    for name in ("payload_fused_strip", "demap", "sc_metric", "cp_strip"):
        require(any(v >= 1 for v in streamed["launches"].get(name,
                                                             {}).values()),
                f"{name} was not launched on a streamed path")
    rows = {name: (launched[name], errors[name], *dev_ms[name])
            for name in KERNELS}
    for name, row in rows.items():
        require(row[0] >= 1, f"{name} was not launched on its path")
    emit({"phase": "wall", "card": card,
          "seconds": time.perf_counter() - t_start})
    emit({"kernels": [{
        "name": name,
        "route": "cuda",
        "source": f"rub_mimo_tpu_torch/kernels/csrc/{KERNELS[name][2]}.cu",
        "replaces": KERNELS[name][3],
        "launches": n_launch,
        "max_abs_err": err,
        "ms": t_k,
        "plain_ms": t_p,
        "bound_ms": bounds[name]["bound_ms"],
        "bound_by": bounds[name]["bound_by"],
        "library_ms": t_lib,
        "bound_share": bounds[name]["bound_ms"] / t_k,
        **extra.get(name, {}),
    } for name, (n_launch, err, t_k, t_p, t_lib) in rows.items()]})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})


if __name__ == "__main__":
    main()
    sys.exit(0)
