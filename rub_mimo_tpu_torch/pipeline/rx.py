"""The RX decode pipeline, eagerly in PyTorch.

Port of rub_mimo_tpu/pipeline/rx.py:

  capture [streams, T]
    -> Schmidl&Cox sync -> sync_index                  (sync/schmidl_cox)
       (+ the S0 cross-correlation fallback, sync_fallback)
    -> coarse CFO de-rotation of the capture (correct_cfo)
    -> estimation region: one symbol of lead-in, S0 + access codes, M
       samples of margin (the prefix of the reference's windowcf,
       framing.cc:284, 639-651)
    -> matched-filter offset search                    (sync/matched_filter)
    -> residual CFO, region de-rotation, second search (correct_cfo)
    -> LS channel estimate Ghat (+ delay-domain smoothing)  (estimate/)
    -> detector weights from the occupied carriers     (detect/weights)
    -> payload slice from the last access code's peak + M (framing.cc:857)
    -> payload tail, one of:
       K1  CP strip + FFT + equalize + demap in one kernel
           (kernels.payload_fused.payload_fused_strip; the flat payload
           de-rotated by the residual CFO first)
       or the CP strip (kernels.cp_strip, K7), the residual-CFO ramp on
       the symbols, then
       K2  FFT + equalize + demap (kernels.payload_fused.payload_fused)
       K3  torch.fft, then equalize + demap (kernels.eq_demap.eq_demap)
       or the generic tail: torch.fft, the occupied-carrier gather,
           Alamouti combining, channel tracking or the mode/detector
           dispatch (SISO, diversity, ZF/MMSE, SIC, ML), the postprocess
           (normalize_rx_scale, track_phase), and the hard demap
           (kernels.eq_demap.demap, K4, on CUDA).

payload_impl picks the tail: "auto" and "fused_strip" K1, "fused" K2,
"eqdemap" K3, "xla" the generic tail.  A kernel tail runs only where its
gate holds (``kernel_applicable``: all subcarriers occupied, RX_ZF, ZF
or MMSE, no tracking, and the kernel's own geometry); elsewhere the
decode takes the generic tail, as the JAX package does.  "fused_packed"
(the TPU kernel's packed subcarrier order) is refused.  Every kernel
wrapper launches on CUDA tensors and runs its plain PyTorch version on
CPU tensors.  Outputs are in natural subcarrier order with exactly
pid_max frames.

Host synchronizations on a GPU (each drains the stream): only the coarse
sync's two early-exit tests.  Under sync_impl "xla" or "pallas" the
decode reads nothing back: the region and payload slices start at device
scalars (``extract_payload``), and the fallback and the CFO steps are
computed on the device and selected with torch.where.  So those decodes
can be captured in a CUDA graph: ``make_serving_decoder`` serves a stack
of captures by replaying one graph per capture shape.  ``decode_all``
decodes the bursts of one long capture one after another.
"""

from __future__ import annotations

import functools
import gc
from typing import NamedTuple, Optional

import numpy as np
import torch

from rub_mimo_tpu_torch.config import (CommMode, Detector, ModemConfig,
                                       check_config)
from rub_mimo_tpu_torch.detect import (alamouti, dispatch, postprocess,
                                       tracking)
from rub_mimo_tpu_torch.detect import weights as weights_mod
from rub_mimo_tpu_torch.estimate import cfo as cfo_mod
from rub_mimo_tpu_torch.estimate import ls, smooth
from rub_mimo_tpu_torch.kernels import cp_strip as cp_strip_mod
from rub_mimo_tpu_torch.kernels import eq_demap as eq_demap_mod
from rub_mimo_tpu_torch.kernels import payload_fused
from rub_mimo_tpu_torch.ofdm import constellation, sctype
from rub_mimo_tpu_torch.sync import matched_filter, schmidl_cox, xcorr_sync
from rub_mimo_tpu_torch.utils import profiling
from rub_mimo_tpu_torch.utils.device import on_device
from rub_mimo_tpu_torch.utils.device_cache import device_constant

PAYLOAD_IMPLS = ("auto", "fused_strip", "fused", "eqdemap", "xla")


class DecodeResult(NamedTuple):
    synced: torch.Tensor          # bool
    sync_index: torch.Tensor      # int64 (framesync::get_sync_index)
    sync_sample: torch.Tensor     # int64 — sample where sync fired
    plateau_start: torch.Tensor   # int64[streams]
    plateau_end: torch.Tensor     # int64[streams]
    cfo_hat: torch.Tensor         # float32, subcarrier units (total)
    cfo_coarse: torch.Tensor      # float32 — the whole-capture component
    G: torch.Tensor               # complex64[M, rx, tx] (framesync::get_G)
    W: torch.Tensor               # complex64[M_occ, out, rx]
    normalize_gain: torch.Tensor  # float32[M_occ]
    s0_index: torch.Tensor        # int64[streams]
    ac_index: torch.Tensor        # int64[streams, codes*streams]
    decode_start: torch.Tensor    # int64 — window offset of first payload CP
    rx_sig: torch.Tensor | None   # complex64[streams, pid_max * M_occ]
    rx_data: torch.Tensor         # int32[streams, pid_max * M_occ]
    symbol_valid: torch.Tensor    # bool[pid_max] — symbol inside capture
    metric: torch.Tensor | None   # float32[streams, T] when keep_debug
    mf_traces: torch.Tensor | None  # float32[streams, n_seq, symbol_len] "
    Y: torch.Tensor | None = None  # complex64[pid_max, rx, M_occ], the raw
                                   # payload grid, kept for the ML detector


@device_constant
def _arange_on(n: int, device: torch.device) -> torch.Tensor:
    """[n] int32 0, 1, ..., n - 1 on ``device``, made once."""
    return torch.arange(n, dtype=torch.int32, device=device)


def _start_on(start, device: torch.device) -> torch.Tensor:
    """A window start as a device int64 scalar; a Python int is filled in
    on the device (no host-to-device copy)."""
    if isinstance(start, torch.Tensor):
        return start.to(device=device, dtype=torch.int64)
    return torch.full((), int(start), dtype=torch.int64, device=device)


def window_index(cstart, plen: int, T: int, device: torch.device):
    """(src [plen] int32, outside [plen] bool) of the window
    [cstart, cstart + plen) of a T-sample capture: each position's sample,
    clamped into the capture, and whether it lies outside it.  cstart is
    a device scalar or a Python int; nothing is read back."""
    idx = _start_on(cstart, device) + _arange_on(plen, device)  # int32
    src = torch.clamp(idx, 0, max(T - 1, 0))
    return src, src != idx


def gather_window(iq: torch.Tensor, src: torch.Tensor, outside: torch.Tensor,
                  out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """iq[:, src] [S, plen] with zeros where ``outside`` (window_index's
    pair), into ``out`` when given.  One index serves every stream."""
    out = torch.index_select(iq, 1, src, out=out)
    return out.masked_fill_(outside, 0)


def extract_payload(iq: torch.Tensor, cstart, plen: int,
                    out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``iq[:, cstart : cstart + plen]`` with the windowcf's read-zeros
    semantics outside the capture (framing.cc:284, 639-651): the in-range
    part copied, the rest zeros.  Any dtype; cstart is a device int64
    scalar (a Python int becomes one) and may be negative or past the
    end; it is never read on the host.  Written into ``out`` ([S, plen],
    iq's dtype, contiguous) when given."""
    return gather_window(iq, *window_index(cstart, plen, iq.shape[-1],
                                           iq.device), out=out)


def _extract_region(iq: torch.Tensor, sync_index,
                    cfg: ModemConfig) -> torch.Tensor:
    """The estimation prefix of the replay window, starting one symbol
    before sync_index (a device scalar or a Python int):
    [streams, symbol_len*(1 + codes*streams) + M]."""
    region_len = cfg.symbol_len * (1 + cfg.num_access_codes
                                   * cfg.num_streams) + cfg.M
    start = (torch.clamp(_start_on(sync_index, iq.device), 0, iq.shape[-1])
             - cfg.symbol_len)
    return extract_payload(iq, start, region_len)


def check_supported(cfg: ModemConfig, payload_impl: str = "auto") -> None:
    """Raise for what the port's decode does not take: a config that is
    not the port's ModemConfig (TypeError: its enums would compare
    unequal; see convert.config_from_jax) and an unknown payload_impl
    (ValueError; "fused_packed" is the TPU kernel's packed subcarrier
    layout, which the port does not have)."""
    check_config(cfg, "rub_mimo_tpu_torch decode")
    if payload_impl not in PAYLOAD_IMPLS:
        raise ValueError(f"unknown payload_impl {payload_impl!r}; the port "
                         f"has {PAYLOAD_IMPLS}")


@functools.lru_cache(maxsize=32)
def _occupied(cfg: ModemConfig):
    """(all subcarriers occupied?, the occupied indices, numpy int64)."""
    occ = sctype.occupied_indices(sctype.allocation(cfg)).astype(np.int64)
    all_occ = occ.size == cfg.M and np.array_equal(occ, np.arange(cfg.M))
    return bool(all_occ), occ


@device_constant
def _occupied_on(cfg: ModemConfig, device: torch.device) -> torch.Tensor:
    return torch.as_tensor(_occupied(cfg)[1], device=device)


def kernel_applicable(cfg: ModemConfig, impl: str = "fused_strip") -> bool:
    """The config-level gate of the payload kernels (JAX's
    _payload_kernel_applicable): a plain W/gain equalize + hard demap on
    an all-occupied allocation (RX_ZF, ZF or MMSE, no channel or phase
    tracking), within the kernel's own geometry: "fused_strip" (and
    "auto") K1, "fused" K2, "eqdemap" K3.  "xla" names no kernel."""
    if not (_occupied(cfg)[0] and cfg.mode == CommMode.RX_ZF
            and cfg.detector in (Detector.ZF, Detector.MMSE)
            and not cfg.track_channel and not cfg.track_phase):
        return False
    arity = len(constellation.table(cfg.modulation))
    S = cfg.num_streams
    if impl in ("auto", "fused_strip", "fused"):  # K2 takes what K1 takes
        return payload_fused.strip_supported(cfg.M, S, arity)
    if impl == "eqdemap":
        return eq_demap_mod.supported(S, arity)
    return False


def derotate_payload(payload: torch.Tensor, residual_cfo: torch.Tensor,
                     decode_start: torch.Tensor, M: int) -> torch.Tensor:
    """The residual CFO de-rotation of the flat payload [S, plen] (CP
    samples too; the strip drops them): its phase reference is the
    window origin, and flat element l sits at window offset decode_start
    + l (rx.py:458-469 of the JAX package)."""
    lidx = torch.arange(payload.shape[-1], dtype=torch.float32,
                        device=payload.device)
    rot = torch.exp(-2j * np.pi * residual_cfo
                    * (decode_start.to(torch.float32) + lidx) / np.float32(M))
    return payload * rot


def derotate_symbols(x_t: torch.Tensor, residual_cfo: torch.Tensor,
                     decode_start: torch.Tensor,
                     cfg: ModemConfig) -> torch.Tensor:
    """The residual CFO de-rotation of the CP-stripped symbols
    [S, n_sym, M]: symbol k's sample j sits at window offset decode_start
    + k*symbol_len + cp_len + j (rx.py:502-518 of the JAX package)."""
    n_sym, M = x_t.shape[1], x_t.shape[2]
    dev = x_t.device
    wrel = (decode_start.to(torch.float32)
            + torch.arange(n_sym, dtype=torch.float32, device=dev)[:, None]
            * np.float32(cfg.symbol_len)
            + np.float32(cfg.cp_len)
            + torch.arange(M, dtype=torch.float32, device=dev)[None, :])
    rot = torch.exp(-2j * np.pi * residual_cfo * wrel / np.float32(M))
    return x_t * rot


def strip_payload(iq: torch.Tensor, planes, cstart,
                  cfg: ModemConfig) -> torch.Tensor:
    """The CP-stripped payload symbols x_t [S, pid_max, M] complex64
    through the K7 kernel (kernels.cp_strip) on CUDA, from the window at
    cstart (a device scalar or a Python int).  From (re, im) planes both
    are extracted into one [2S, plen] buffer and stripped in one call;
    the complex capture is not formed."""
    S, n_sym, sym = cfg.num_streams, cfg.pid_max, cfg.symbol_len
    plen = n_sym * sym
    if planes is None:
        return cp_strip_mod.cp_strip(extract_payload(iq, cstart, plen),
                                     n_sym, sym, cfg.cp_len)
    dev = planes[0].device
    flat = torch.empty((2 * S, plen), dtype=torch.float32, device=dev)
    win = window_index(cstart, plen, planes[0].shape[-1], dev)
    for i, p in enumerate(planes):
        gather_window(p, *win, out=flat[i * S:(i + 1) * S])
    x = cp_strip_mod.cp_strip(flat, n_sym, sym, cfg.cp_len)
    return torch.complex(x[:S], x[S:])


def symbol_grid(x_t: torch.Tensor, cfg: ModemConfig) -> torch.Tensor:
    """The frequency grid of the CP-stripped symbols x_t [S, n_sym, M]:
    the FFT scaled by 1/sqrt(M_occ) on the occupied carriers, as
    Y [n_sym, S(rx), M_occ]."""
    X = torch.fft.fft(x_t, dim=-1) * float(
        np.float32(1.0 / np.sqrt(cfg.M_occupied)))
    if not _occupied(cfg)[0]:
        X = X[:, :, _occupied_on(cfg, X.device)]
    return X.transpose(0, 1)


def occupied_channel(G: torch.Tensor, cfg: ModemConfig) -> torch.Tensor:
    """G [M, rx, tx] on the occupied carriers (G itself when all are)."""
    return G if _occupied(cfg)[0] else G[_occupied_on(cfg, G.device)]


def payload_tail(x_t: torch.Tensor, G_occ: torch.Tensor, W: torch.Tensor,
                 gain: torch.Tensor, cfg: ModemConfig):
    """The generic payload tail (rx.py:577-635 of the JAX package) on the
    CP-stripped symbols x_t [S, n_sym, M]: FFT scaled by 1/sqrt(M_occ),
    the occupied-carrier gather, Alamouti combining, channel tracking or
    the mode/detector dispatch, the postprocess, and the hard demap.
    Returns (rx_sig, rx_data [S, n_sym*M_occ], Y [n_sym, S, M_occ])."""
    S, n_sym = x_t.shape[0], x_t.shape[1]
    m_occ = cfg.M_occupied
    Y = symbol_grid(x_t, cfg)  # [n_sym, S(rx), m_occ]
    if cfg.mode == CommMode.ALAMOUTI:
        eq = torch.zeros_like(Y)
        eq[:, 0, :] = alamouti.combine_pairs(Y, G_occ)
    elif cfg.track_channel:
        eq, _ = tracking.track_and_equalize(
            Y, G_occ, cfg, block_frames=cfg.track_block_frames,
            alpha=cfg.track_alpha)
    else:
        eq = dispatch.equalize_dispatch(Y, G_occ, W, gain, cfg)
    eq = postprocess.postprocess_eq(eq, cfg)
    rx_sig = eq.transpose(0, 1).reshape(S, n_sym * m_occ)
    rx_data = constellation.demodulate(rx_sig, cfg.modulation)
    return rx_sig, rx_data, Y


def decode(iq, cfg: ModemConfig, *, keep_debug: bool = False,
           sync_impl: str = "coarse", payload_impl: str = "auto",
           keep_rx_sig: bool = True) -> DecodeResult:
    """Decode a whole capture.

    iq: [num_streams, T] complex64, or a (re, im) pair of float32 planes;
    every stage runs on iq's device.  sync_impl: "coarse", "xla" or
    "pallas" (sync.schmidl_cox.synchronize).  payload_impl: the payload
    tail (see the module note).  keep_debug keeps the sync metric (the
    full-rate scan's; none under "pallas") and the matched filter's
    traces; keep_rx_sig=False drops the equalized symbols.

    While spans are on, a device mark is launched at each stage bound
    (utils/profiling.py MARKS): the planes' complex capture, sync (and
    the fallback and coarse CFO), timing (region and matched filter, the
    residual CFO), channel (LS, smoothing, the detector weights), the
    payload window (and K7 on the strip tails), the tail."""
    check_supported(cfg, payload_impl)
    mark = profiling.marker((iq[0] if isinstance(iq, tuple) else iq).device)
    mark(0)
    if isinstance(iq, tuple):
        re, im = iq
        planes = (re, im)
        iq = torch.complex(re, im)
    else:
        planes = None
    mark(1)
    S = cfg.num_streams
    M = cfg.M
    sym = cfg.symbol_len
    T = iq.shape[-1]

    sync = schmidl_cox.synchronize(iq, cfg, keep_metric=keep_debug,
                                   impl=sync_impl)
    synced = sync.synced
    sync_index = sync.sync_index
    use_fb = torch.zeros_like(synced)
    if cfg.sync_fallback:
        fb = xcorr_sync.s0_xcorr_sync(iq, cfg)
        use_fb = ~synced & (fb.quality > cfg.sync_fallback_threshold)
        synced = synced | use_fb
        sync_index = torch.where(use_fb, fb.sync_index, sync_index)
    zero = torch.zeros_like(sync.cfo_hat)
    coarse_cfo = sync.cfo_hat
    if cfg.correct_cfo:
        # the plateau correlation is garbage when sync came from the
        # fallback: that case's coarse estimate comes from the S0 halves
        coarse_cfo = torch.where(use_fb, zero, sync.cfo_hat)
        iq = schmidl_cox.correct_cfo(iq, coarse_cfo, M)
        planes = None
    mark(2)
    region = _extract_region(iq, sync_index, cfg)

    joint = (not cfg.bit_exact) and cfg.timing_mode == "joint"
    mf = matched_filter.search(region, cfg, joint=joint,
                               keep_traces=keep_debug)
    cfo_total = coarse_cfo
    if cfg.correct_cfo:
        eps_s0 = torch.where(
            use_fb, cfo_mod.s0_halves_cfo(region, mf.s0_index, cfg), zero)
        eps = cfo_mod.residual_cfo(
            schmidl_cox.correct_cfo(region, eps_s0, M)
            if cfg.sync_fallback else region, mf.ac_index, cfg)
        residual = eps_s0 + eps
        region = schmidl_cox.correct_cfo(region, residual, M)
        mf = matched_filter.search(region, cfg, joint=joint,
                                   keep_traces=keep_debug)
        cfo_total = coarse_cfo + residual
    mark(3)
    G = ls.estimate_channel(region, mf.ac_index, cfg)
    if cfg.smooth_channel:
        G = smooth.smooth_channel_estimate(G, cfg)
    G_occ = occupied_channel(G, cfg)
    W, gain = weights_mod.weights_for(cfg, G, G_occ, region, mf.ac_index)
    mark(4)

    # the payload starts at the last access code's peak + M on the last
    # rx stream (the reference hardcodes rx index 1, framing.cc:857)
    decode_start = mf.ac_index[S - 1, -1] + M
    n_sym = cfg.pid_max
    plen = n_sym * sym
    # the window's start in the capture, on the device (rx.py:440 of the
    # JAX package)
    cstart = torch.clamp(sync_index, 0, T) + decode_start - sym
    table = constellation.table(cfg.modulation)
    norm = np.float32(1.0 / np.sqrt(cfg.M_occupied))
    Y = None
    if (payload_impl in ("auto", "fused_strip")
            and kernel_applicable(cfg, payload_impl)):
        if planes is not None:
            win = window_index(cstart, plen, T, iq.device)
            p_re, p_im = (gather_window(p, *win) for p in planes)
        else:
            payload = extract_payload(iq, cstart, plen)
            if cfg.correct_cfo:
                payload = derotate_payload(payload, residual, decode_start, M)
            p_re, p_im = payload.real.contiguous(), payload.imag.contiguous()
        mark(5)
        rx_sig, rx_data = payload_fused.payload_fused_strip(
            p_re, p_im, W, gain, table, norm, n_sym=n_sym, symbol_len=sym,
            cp_len=cfg.cp_len, emit_sig=keep_rx_sig)
    else:
        x_t = strip_payload(iq, planes, cstart, cfg)
        if cfg.correct_cfo:
            x_t = derotate_symbols(x_t, residual, decode_start, cfg)
        mark(5)
        if payload_impl == "fused" and kernel_applicable(cfg, "fused"):
            rx_sig, rx_data = payload_fused.payload_fused(
                x_t, W, gain, table, norm, emit_sig=keep_rx_sig)
        elif payload_impl == "eqdemap" and kernel_applicable(cfg, "eqdemap"):
            X = torch.fft.fft(x_t, dim=-1) * float(norm)
            rx_sig, rx_data = eq_demap_mod.eq_demap(X, W, gain, table,
                                                    emit_sig=keep_rx_sig)
        else:
            rx_sig, rx_data, Y = payload_tail(x_t, G_occ, W, gain, cfg)
            if not keep_rx_sig:
                rx_sig = None
            if cfg.detector != Detector.ML:
                Y = None

    # a symbol is valid when it lies wholly inside the capture
    win_valid = (T + sym) - sync_index
    ends = decode_start + (torch.arange(n_sym, device=iq.device) + 1) * sym
    symbol_valid = (ends <= win_valid) & synced
    rx_data = rx_data.reshape(S, -1)
    mark(6)
    return DecodeResult(
        synced=synced,
        sync_index=sync_index,
        sync_sample=sync.sync_sample,
        plateau_start=sync.plateau_start,
        plateau_end=sync.plateau_end,
        cfo_hat=cfo_total,
        cfo_coarse=coarse_cfo if cfg.correct_cfo else zero,
        G=G,
        W=W,
        normalize_gain=gain,
        s0_index=mf.s0_index,
        ac_index=mf.ac_index,
        decode_start=decode_start,
        rx_sig=None if rx_sig is None else rx_sig.reshape(S, -1),
        rx_data=rx_data,
        symbol_valid=symbol_valid,
        metric=sync.metric,
        mf_traces=mf.traces,
        Y=Y,
    )


def make_decoder(cfg: ModemConfig, *, device, input_format: str = "complex",
                 keep_rx_sig: bool = True, keep_debug: bool = False,
                 sync_impl: str = "coarse", payload_impl: str = "auto"):
    """A decode closure for a fixed config on ``device``, with decode's
    keep_rx_sig, keep_debug, sync_impl and payload_impl.

    input_format="complex": the closure takes one [S, T] complex64
    capture; "planes": it takes (re, im) float32 planes, the format
    ingest paths produce, which reach the payload kernels without a
    complex capture.  Inputs are moved to ``device`` if they are
    elsewhere.  On CUDA, float32 matrix products are kept in full float32
    (TF32 off for matmul and cuDNN): TF32 would round the weights and the
    channel-inversion products to ~3 digits."""
    check_supported(cfg, payload_impl)
    device = on_device(device)
    if sync_impl not in schmidl_cox.IMPLS:
        raise ValueError(f"unknown sync_impl {sync_impl!r}")
    kw = dict(keep_rx_sig=keep_rx_sig, keep_debug=keep_debug,
              sync_impl=sync_impl, payload_impl=payload_impl)

    if input_format == "planes":
        def _decode(re, im):
            return decode(
                (torch.as_tensor(re, dtype=torch.float32, device=device),
                 torch.as_tensor(im, dtype=torch.float32, device=device)),
                cfg, **kw)
    elif input_format == "complex":
        def _decode(iq):
            return decode(
                torch.as_tensor(iq, dtype=torch.complex64, device=device),
                cfg, **kw)
    else:
        raise ValueError(f"unknown input_format {input_format!r}")
    return _decode


WARMUP_DECODES = 2  # eager decodes before a capture: plans, caches, pool


class CapturedDecode:
    """One CUDA graph of the single-capture decode ``fn`` for one input
    shape: static input buffers, the graph, and its static outputs (a
    DecodeResult), which each replay overwrites.

    ``fn`` is first run WARMUP_DECODES times on a side stream on the
    static buffers, which builds the cuFFT plans, the kernels' launch
    attributes and the cached device tables (``device_constant``: never
    freed, since the graph reads them by address) and fills the
    allocator, then captured.  A decode that reads back to the host, or
    uploads from pageable host memory, cannot be captured and raises
    here.  The warm decodes launch no device marks; the graph holds them
    if spans are on (utils/profiling.py).  Set-up spans: ``setup.graph``
    and its children ``setup.warm_decode`` (each)."""

    def __init__(self, fn, first, device: torch.device):
        profiling.count("serve.graph_captures")
        with profiling.setup_span("setup.graph"):
            self._build(fn, first, device)

    def _build(self, fn, first, device: torch.device) -> None:
        self.inputs = [x.clone() for x in first]
        with torch.cuda.device(device):
            side = torch.cuda.Stream()
            side.wait_stream(torch.cuda.current_stream())
            with torch.cuda.stream(side), profiling.no_marks():
                for _ in range(WARMUP_DECODES):
                    with profiling.setup_span("setup.warm_decode"):
                        fn(*self.inputs)
            torch.cuda.current_stream().wait_stream(side)
            self.graph = torch.cuda.CUDAGraph()
            # an unreachable graph (an earlier serving decoder's, held in
            # a reference cycle) destroyed by the garbage collector during
            # this capture would invalidate it: collect first, and hold
            # the collector off until the capture ends
            gc.collect()
            collecting = gc.isenabled()
            gc.disable()
            try:
                with torch.cuda.graph(self.graph):
                    self.outputs = fn(*self.inputs)
            finally:
                if collecting:
                    gc.enable()

    def copy_in(self, *captures, rec=None) -> None:
        """Copy ``captures`` into the static inputs; each copy counts in
        ``serve.copies`` and ``serve.bytes`` while ``rec`` records."""
        for buf, x in zip(self.inputs, captures):
            buf.copy_(x)
            if rec is not None:
                rec.copied(buf.nbytes)


def _stack_results(results) -> DecodeResult:
    return DecodeResult(*(
        None if f is None else torch.stack([r[i] for r in results])
        for i, f in enumerate(results[0])))


def make_serving_decoder(cfg: ModemConfig, *, device,
                         payload_impl: str = "auto", keep_rx_sig: bool = True,
                         input_format: str = "complex",
                         sync_impl: str = "pallas"):
    """Throughput serving: a decoder of [batch, S, T] stacks (port of the
    JAX package's make_serving_decoder, its lax.scan over the batch).

    input_format="complex": the closure takes a [B, S, T] complex64
    stack; "planes": (re, im) [B, S, T] float32 stacks.  It returns a
    DecodeResult with every field stacked on a leading batch dim, metric
    and mf_traces None.  Inputs are moved to ``device``.

    On CUDA each capture is served by one replay of a CUDA graph of the
    single-capture decode (``CapturedDecode``), captured at the first
    stack of each capture shape and kept: its input copied into the
    graph's static buffers, the replay, and its outputs copied out.  The
    graph needs a decode that reads nothing back, so sync_impl must be
    "pallas" (K5; not with a sync_quorum, which K5 does not take) or
    "xla" (the full-rate scan, K6); "coarse" reads its early exit back
    and raises ValueError.  A capture that fails raises; nothing falls
    back to eager code.  On the CPU the eager decode runs per capture.

    While spans record (utils/profiling.py) each call is a span
    ``serve`` (one sequence number a capture) with children
    ``serve.prepare`` (the stacks, the graph's lookup or build, the
    outputs' allocation), and per capture ``serve.copy_in``,
    ``serve.replay`` (the graph's launch) and ``serve.copy_out``; the
    counters ``serve.captures``, ``serve.copies`` and ``serve.bytes``
    count the captures and, where each is issued, the eager copies and
    their bytes (a stack that ``torch.as_tensor`` moves or converts, the
    inputs in, the outputs out)."""
    check_supported(cfg, payload_impl)
    if sync_impl not in schmidl_cox.IMPLS:
        raise ValueError(f"unknown sync_impl {sync_impl!r}")
    if input_format not in ("complex", "planes"):
        raise ValueError(f"unknown input_format {input_format!r}")
    if torch.device(device).type == "cuda" and (
            sync_impl == "coarse"
            or (sync_impl == "pallas" and cfg.sync_quorum is not None)):
        raise ValueError(
            f"make_serving_decoder: sync_impl {sync_impl!r} reads back to "
            "the host (the coarse scan's early exit; a sync_quorum turns "
            "'pallas' into 'coarse'), so it cannot be served from a CUDA "
            "graph: use sync_impl='pallas' or 'xla'")
    device = on_device(device)
    planes = input_format == "planes"
    dtype = torch.float32 if planes else torch.complex64

    def one(*x) -> DecodeResult:
        r = decode(tuple(x) if planes else x[0], cfg, sync_impl=sync_impl,
                   payload_impl=payload_impl, keep_rx_sig=keep_rx_sig)
        return r._replace(metric=None, mf_traces=None)

    def serve(*stacks) -> DecodeResult:
        rec = profiling.recording()
        if rec is None:
            return _serve(stacks, None)
        rec.next_seq()
        top = rec.begin("serve")
        try:
            return _serve(stacks, rec)
        finally:
            rec.finish(top)

    def _serve(stacks, rec) -> DecodeResult:
        if rec is not None:
            span = rec.begin("serve.prepare")
        if len(stacks) != (2 if planes else 1):
            raise ValueError(f"input_format {input_format!r} takes "
                             f"{2 if planes else 1} stacks, got {len(stacks)}")
        given = stacks
        stacks = [torch.as_tensor(s, dtype=dtype, device=device)
                  for s in stacks]
        if rec is not None:
            for g, s in zip(given, stacks):
                if profiling.copied_by_as_tensor(g, s):
                    rec.copied(s.nbytes)
        shape = tuple(stacks[0].shape)
        if len(shape) != 3 or any(tuple(s.shape) != shape for s in stacks):
            raise ValueError("make_serving_decoder: expected [batch, S, T] "
                             f"stacks, got {[tuple(s.shape) for s in stacks]}")
        if device.type != "cuda":
            if rec is not None:
                rec.finish(span)
                rec.add("serve.captures", shape[0])
                rec.seq += shape[0] - 1
            return _stack_results([one(*(s[i] for s in stacks))
                                   for i in range(shape[0])])
        graph = serve.graphs.get(shape[1:])
        if graph is None:
            graph = serve.graphs[shape[1:]] = CapturedDecode(
                one, [s[0] for s in stacks], device)
        out = [None if o is None else torch.empty(
            (shape[0], *o.shape), dtype=o.dtype, device=o.device)
            for o in graph.outputs]
        if rec is not None:
            rec.finish(span)
            rec.add("serve.captures", shape[0])
        for i in range(shape[0]):
            if rec is not None:
                if i:
                    rec.next_seq()
                span = rec.begin("serve.copy_in")
            graph.copy_in(*(s[i] for s in stacks), rec=rec)
            if rec is not None:
                rec.finish(span)
                span = rec.begin("serve.replay")
            graph.graph.replay()
            if rec is not None:
                rec.finish(span)
                span = rec.begin("serve.copy_out")
            for o, v in zip(out, graph.outputs):
                if o is not None:
                    o[i].copy_(v)
                    if rec is not None:
                        rec.copied(v.nbytes)
            if rec is not None:
                rec.finish(span)
        return DecodeResult(*out)

    serve.graphs = {}  # capture shape (S, T) -> CapturedDecode
    return serve


def decode_all(iq, cfg: ModemConfig, *, device, max_bursts: int = 4,
               sync_impl: str = "coarse", payload_impl: str = "auto"):
    """Decode several frame bursts from one long capture [S, T] complex64
    (port of the JAX package's decode_all): decode, stop at the first
    decode that does not sync (one host read a burst), zero the consumed
    window_len + symbol_len samples from clamp(sync_index - symbol_len,
    0, T) and decode again, up to max_bursts.  Bursts must lie at least
    one replay window apart.  The caller's tensor is never modified (the
    erasures go to a copy).  Returns a list of DecodeResults."""
    dec = make_decoder(cfg, device=device, sync_impl=sync_impl,
                       payload_impl=payload_impl)
    x = torch.as_tensor(iq, dtype=torch.complex64,
                        device=torch.device(device)).clone()
    T = x.shape[-1]
    erase_len = cfg.window_len + cfg.symbol_len
    pos = torch.arange(T, device=x.device)
    results = []
    for _ in range(max_bursts):
        r = dec(x)
        if not bool(r.synced):
            break
        results.append(r)
        start = torch.clamp(r.sync_index - cfg.symbol_len, 0, T)
        x.masked_fill_((pos >= start) & (pos < start + erase_len), 0)
    return results
