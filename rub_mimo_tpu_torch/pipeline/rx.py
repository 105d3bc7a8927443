"""The RX decode pipeline, eagerly in PyTorch.

Port of rub_mimo_tpu/pipeline/rx.py for the RX_ZF mode with the ZF or
MMSE detector, no tracking, on an all-occupied allocation:

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
    -> ZF / MMSE weights (MMSE sigma^2 measured, mmse_auto_noise)
    -> payload slice from the last access code's peak + M (framing.cc:857),
       de-rotated by the residual CFO (correct_cfo)
    -> CP strip + FFT + equalize + hard demap          (kernels/payload_fused)

The payload tail is the CUDA kernel when the capture is on a CUDA device
and the config passes the kernel's geometry gate (decided from the config
alone), and the plain PyTorch tail otherwise.  Outputs are in natural
subcarrier order with exactly pid_max frames.

Host synchronizations on a GPU (each drains the stream): the coarse
sync's two early-exit tests (none under sync_impl "xla" or "pallas"),
reading sync_index for the region and payload slices, and reading
decode_start for the payload slice.  The fallback and the CFO steps are
computed on the device and selected with torch.where.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from rub_mimo_tpu.config import CommMode, Detector, ModemConfig
from rub_mimo_tpu_torch.detect import weights as weights_mod
from rub_mimo_tpu_torch.estimate import cfo as cfo_mod
from rub_mimo_tpu_torch.estimate import ls, smooth
from rub_mimo_tpu_torch.kernels import payload_fused
from rub_mimo_tpu_torch.ofdm import constellation, sctype
from rub_mimo_tpu_torch.sync import matched_filter, schmidl_cox, xcorr_sync


class DecodeResult(NamedTuple):
    synced: torch.Tensor          # bool
    sync_index: torch.Tensor      # int64 (framesync::get_sync_index)
    sync_sample: torch.Tensor     # int64 — sample where sync fired
    plateau_start: torch.Tensor   # int64[streams]
    plateau_end: torch.Tensor     # int64[streams]
    cfo_hat: torch.Tensor         # float32, subcarrier units (total)
    cfo_coarse: torch.Tensor      # float32 — the whole-capture component
    G: torch.Tensor               # complex64[M, rx, tx] (framesync::get_G)
    W: torch.Tensor               # complex64[M, out, rx]
    normalize_gain: torch.Tensor  # float32[M]
    s0_index: torch.Tensor        # int64[streams]
    ac_index: torch.Tensor        # int64[streams, codes*streams]
    decode_start: torch.Tensor    # int64 — window offset of first payload CP
    rx_sig: torch.Tensor | None   # complex64[streams, pid_max * M]
    rx_data: torch.Tensor         # int32[streams, pid_max * M]
    symbol_valid: torch.Tensor    # bool[pid_max] — symbol inside capture
    metric: torch.Tensor | None   # float32[streams, T] when keep_debug
    mf_traces: torch.Tensor | None  # float32[streams, n_seq, symbol_len] "


def extract_payload(iq: torch.Tensor, cstart: int, plen: int) -> torch.Tensor:
    """``iq[:, cstart : cstart + plen]`` with the windowcf's read-zeros
    semantics outside the capture (framing.cc:284, 639-651): the in-range
    part copied into a zeroed [S, plen] buffer.  Any dtype; cstart may be
    negative or past the end."""
    S, T = iq.shape
    out = torch.zeros((S, plen), dtype=iq.dtype, device=iq.device)
    lo = min(max(-cstart, 0), plen)
    hi = max(min(T - cstart, plen), lo)
    out[:, lo:hi] = iq[:, cstart + lo: cstart + hi]
    return out


def _extract_region(iq: torch.Tensor, sync_index: int,
                    cfg: ModemConfig) -> torch.Tensor:
    """The estimation prefix of the replay window, starting one symbol
    before sync_index: [streams, symbol_len*(1 + codes*streams) + M]."""
    region_len = cfg.symbol_len * (1 + cfg.num_access_codes
                                   * cfg.num_streams) + cfg.M
    start = min(max(sync_index, 0), iq.shape[-1]) - cfg.symbol_len
    return extract_payload(iq, start, region_len)


def check_supported(cfg: ModemConfig) -> None:
    """Raise NotImplementedError for the decode options not ported yet."""
    missing = [
        name for name, off in (
            ("mode other than rx_zf", cfg.mode != CommMode.RX_ZF),
            ("detector other than zf/mmse",
             cfg.detector not in (Detector.ZF, Detector.MMSE)),
            ("track_channel", cfg.track_channel),
            ("track_phase", cfg.track_phase),
            ("guard-band allocation",
             sctype.m_occupied(cfg) != cfg.num_subcarriers),
        ) if off
    ]
    if missing:
        raise NotImplementedError(
            "not ported to rub_mimo_tpu_torch yet: " + ", ".join(missing))


def kernel_applicable(cfg: ModemConfig) -> bool:
    """The config-level gate for the CUDA payload kernel, for a config
    that check_supported accepts (which already requires RX_ZF, ZF/MMSE,
    no tracking and an all-occupied allocation)."""
    return payload_fused.strip_supported(cfg.M, cfg.num_streams, cfg.arity)


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


def decode(iq, cfg: ModemConfig, *, keep_debug: bool = False,
           sync_impl: str = "coarse", keep_rx_sig: bool = True
           ) -> DecodeResult:
    """Decode a whole capture.

    iq: [num_streams, T] complex64, or a (re, im) pair of float32 planes;
    every stage runs on iq's device.  sync_impl: "coarse", "xla" or
    "pallas" (sync.schmidl_cox.synchronize).  keep_debug keeps the sync
    metric (the full-rate scan's; none under "pallas") and the matched
    filter's traces."""
    check_supported(cfg)
    if isinstance(iq, tuple):
        re, im = iq
        planes = (re, im)
        iq = torch.complex(re, im)
    else:
        planes = None
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
    si = int(sync_index)
    region = _extract_region(iq, si, cfg)

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
    G = ls.estimate_channel(region, mf.ac_index, cfg)
    if cfg.smooth_channel:
        G = smooth.smooth_channel_estimate(G, cfg)
    W, gain = weights_mod.weights_for(cfg, G, region, mf.ac_index)

    # the payload starts at the last access code's peak + M on the last
    # rx stream (the reference hardcodes rx index 1, framing.cc:857)
    decode_start = mf.ac_index[S - 1, -1] + M
    n_sym = cfg.pid_max
    plen = n_sym * sym
    cstart = min(max(si, 0), T) + int(decode_start) - sym
    if planes is not None:
        p_re, p_im = (extract_payload(p, cstart, plen) for p in planes)
    else:
        payload = extract_payload(iq, cstart, plen)
        if cfg.correct_cfo:
            payload = derotate_payload(payload, residual, decode_start, M)
        p_re, p_im = payload.real.contiguous(), payload.imag.contiguous()
    tail = (payload_fused.payload_fused_strip if kernel_applicable(cfg)
            else payload_fused.payload_tail_reference)
    rx_sig, rx_data = tail(
        p_re, p_im, W, gain, constellation.table(cfg.modulation),
        np.float32(1.0 / np.sqrt(sctype.m_occupied(cfg))),
        n_sym=n_sym, symbol_len=sym, cp_len=cfg.cp_len,
        emit_sig=keep_rx_sig)

    # a symbol is valid when it lies wholly inside the capture
    win_valid = (T + sym) - sync_index
    ends = decode_start + (torch.arange(n_sym, device=iq.device) + 1) * sym
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
        rx_sig=None if rx_sig is None else rx_sig.reshape(S, n_sym * M),
        rx_data=rx_data.reshape(S, n_sym * M),
        symbol_valid=(ends <= win_valid) & synced,
        metric=sync.metric,
        mf_traces=mf.traces,
    )


def make_decoder(cfg: ModemConfig, *, device, input_format: str = "complex",
                 keep_rx_sig: bool = True, keep_debug: bool = False,
                 sync_impl: str = "coarse"):
    """A decode closure for a fixed config on ``device``, with decode's
    keep_rx_sig, keep_debug and sync_impl.

    input_format="complex": the closure takes one [S, T] complex64
    capture; "planes": it takes (re, im) float32 planes, the format
    ingest paths produce, which reach the payload kernel without a
    complex split.  Inputs are moved to ``device`` if they are elsewhere.
    On CUDA, float32 matrix products are kept in full float32 (TF32 off
    for matmul and cuDNN): TF32 would round the weights and the
    channel-inversion products to ~3 digits."""
    device = torch.device(device)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(f"make_decoder: device {device} requested "
                               "but CUDA is not available")
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    check_supported(cfg)
    if sync_impl not in schmidl_cox.IMPLS:
        raise ValueError(f"unknown sync_impl {sync_impl!r}")
    kw = dict(keep_rx_sig=keep_rx_sig, keep_debug=keep_debug,
              sync_impl=sync_impl)

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
