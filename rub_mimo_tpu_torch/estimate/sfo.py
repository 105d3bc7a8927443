"""Sampling-frequency-offset estimation and correction.

Port of rub_mimo_tpu/estimate/sfo.py.  A clock offset delta = ppm * 1e-6
slides each OFDM symbol's FFT window by delta * symbol_len samples: a
per-subcarrier phase ramp, linear in both the frame n and the signed
subcarrier k,

    phase(n, k) ~= 2 pi delta k n symbol_len / M   (+ common phase terms).

Estimators: decision-directed and differential in n (``estimate_sfo``:
r = y conj(s_hat) per frame, the moment z = sum r[n+1] conj(r[n]) over
frames and streams), and data-aided over the known access codes
(``preamble_sfo``); both reduce to a per-subcarrier moment z whose phase
``fit_subcarrier_slope`` fits against k by weighted least squares with
an intercept (which absorbs the common phase error and residual CFO).
Correction resamples the capture by 1 / (1 + delta)
(utils.resample.resample_bandlimited); ``decode_with_sfo`` runs the
two-pass flow.  Every estimate stays a device scalar: nothing is read
back to the host.
"""

from __future__ import annotations

import numpy as np
import torch

from rub_mimo_tpu_torch.config import CommMode, Detector, ModemConfig
from rub_mimo_tpu_torch.estimate import ls
from rub_mimo_tpu_torch.ofdm import constellation, sctype
from rub_mimo_tpu_torch.utils.device import on_device
from rub_mimo_tpu_torch.utils.device_cache import device_constant
from rub_mimo_tpu_torch.utils.resample import resample_bandlimited


def estimate_sfo(rx_sig: torch.Tensor, cfg: ModemConfig,
                 n_frames: int | None = None,
                 decisions: torch.Tensor | None = None) -> torch.Tensor:
    """delta (ppm = delta * 1e6), a float32 device scalar, from a decode's
    equalized symbols rx_sig [S, pid_max * M_occupied] (equalized with the
    static preamble estimate, so the ramp is intact).  The decisions are
    rx_sig's own (reliable only while the ramp stays inside the decision
    margin: limit the fit with n_frames) unless given, e.g. from a
    tracking decode, as decode_with_sfo does."""
    S = rx_sig.shape[0]
    y = rx_sig.reshape(S, cfg.pid_max, cfg.M_occupied)
    if decisions is None:
        d = constellation.demodulate(y, cfg.modulation)
    else:
        d = decisions.reshape(S, cfg.pid_max, cfg.M_occupied)
    if n_frames is not None:
        y, d = y[:, :int(n_frames)], d[:, :int(n_frames)]
    s_hat = constellation.table_on(cfg.modulation, y.device)[d.long()]
    r = y * torch.conj(s_hat)                     # decision residuals
    z = torch.sum(r[:, 1:] * torch.conj(r[:, :-1]), dim=(0, 1))  # [m_occ]
    return fit_subcarrier_slope(z, cfg)


@device_constant
def _slope_axis(cfg: ModemConfig, device: torch.device):
    """(k [m_occ] float32, the signed subcarrier index of each occupied
    carrier; keep [m_occ] float32, 0 on the Nyquist bin k = -M/2, whose
    shift phase aliases)."""
    occ = sctype.occupied_indices(sctype.allocation(cfg))
    k = ((occ + cfg.M // 2) % cfg.M) - cfg.M // 2
    return (torch.as_tensor(k.astype(np.float32), device=device),
            torch.as_tensor((k != -(cfg.M // 2)).astype(np.float32),
                            device=device))


def fit_subcarrier_slope(z: torch.Tensor, cfg: ModemConfig) -> torch.Tensor:
    """delta from the per-subcarrier moment z [m_occ]: a weighted LS fit
    angle(z) ~= a + b k (weights |z|, the Nyquist bin left out), and
    b = 2 pi delta symbol_len / M.  Shared by the offline estimators and
    the streaming decoder's accumulator (sfo_correct)."""
    k, keep = _slope_axis(cfg, z.device)
    dphi = torch.angle(z)
    w = z.abs() * keep
    w0 = torch.sum(w)
    wk = torch.sum(w * k)
    wkk = torch.sum(w * k * k)
    wp = torch.sum(w * dphi)
    wkp = torch.sum(w * k * dphi)
    det = w0 * wkk - wk * wk
    b = (w0 * wkp - wk * wp) / torch.where(det == 0, 1.0, det)
    return b * cfg.M / float(np.float32(2.0 * np.pi * cfg.symbol_len))


def preamble_sfo(region: torch.Tensor, ac_index: torch.Tensor,
                 cfg: ModemConfig) -> torch.Tensor:
    """Data-aided delta from the known S1 access codes: per subcarrier,
    the phase advance between consecutive code observations R_c = X_c
    conj(S1) (S * symbol_len samples apart on the TDMA grid) has slope
    2 pi delta k S symbol_len / M, the same moment and fit as the frame
    differential scaled by the code pitch.  Needs no decisions, so it
    acquires the offset where the payload decodes at high SER from frame
    0 (a few ppm rotate the band edges of M = 2048 by ~0.5 rad across the
    41-symbol preamble)."""
    X = ls.code_ffts(region, ls.ac_offsets(ac_index, cfg), cfg)
    S1, _ = ls._s1_and_mask(cfg, region.device)  # [codes, 1, tx, M]
    R = X * torch.conj(S1)
    occ = sctype.occupied_indices(sctype.allocation(cfg))
    if occ.size != cfg.M:
        R = R.index_select(-1, torch.as_tensor(occ, device=R.device))
    z = torch.sum(R[1:] * torch.conj(R[:-1]), dim=(0, 1, 2))
    # fit_subcarrier_slope assumes a symbol_len step; codes step S symbols
    return fit_subcarrier_slope(z, cfg) / cfg.num_streams


def correct_sfo(iq: torch.Tensor, delta) -> torch.Tensor:
    """Undo rx[t] = s(t (1 + delta)): resample at t / (1 + delta).  delta
    is a Python number or a float32 device scalar."""
    if not isinstance(delta, torch.Tensor):
        delta = torch.full((), float(np.float32(delta)), dtype=torch.float32,
                           device=iq.device)
    return resample_bandlimited(iq, 1.0 / (1.0 + delta.to(torch.float32)))


def decode_with_sfo(iq, cfg: ModemConfig, *, device, iters: int = 2,
                    track_block_frames: int | None = None):
    """SFO-corrected decode on ``device`` (ZF-family modes).

    Stage 0 estimates delta from the access codes (preamble_sfo) and
    resamples.  Then each pass (1) decodes with decision-directed channel
    tracking in blocks of track_block_frames (default min(cfg's, 4)),
    whose refits follow the ramp, for reliable decisions over the whole
    run; (2) fits the static decode's intact ramp against those decisions
    (estimate_sfo); (3) resamples.  The helper decodes use a ZF detector
    whatever cfg.detector is (the fit needs soft equalized symbols); the
    final decode uses cfg as given.

    Returns (final DecodeResult, delta_total as a float32 device scalar,
    the corrected capture)."""
    from rub_mimo_tpu_torch.pipeline import rx as rx_mod

    if cfg.mode not in (CommMode.RX_ZF, CommMode.RX_BEAMFORMING):
        # the tracked helper decode refits through the linear equalizer,
        # which config.validate allows only in the ZF-family modes
        raise ValueError(
            "decode_with_sfo requires a ZF-family mode (RX_ZF or "
            f"RX_BEAMFORMING); got {cfg.mode.value}. For single-stream "
            "modes, resample with estimate/correct_sfo directly.")
    bf = track_block_frames
    if bf is None:
        # small blocks: the tracker must out-pace the within-block ramp
        bf = min(cfg.track_block_frames, 4)
        while cfg.pid_max % bf:
            bf -= 1
    cfg_fit = cfg.replace(track_channel=False)
    if cfg.detector in (Detector.ML, Detector.SIC):
        cfg_fit = cfg_fit.replace(detector=Detector.ZF)
    cfg_track = cfg_fit.replace(track_channel=True,
                                track_block_frames=bf).validate()
    dec_fit = rx_mod.make_decoder(cfg_fit, device=device)
    dec_track = rx_mod.make_decoder(cfg_track, device=device)
    iq = torch.as_tensor(iq, dtype=torch.complex64,
                         device=on_device(device))

    fit_result = dec_fit(iq)
    region = rx_mod._extract_region(iq, fit_result.sync_index, cfg_fit)
    delta_total = preamble_sfo(region, fit_result.ac_index, cfg_fit)
    iq = correct_sfo(iq, delta_total)
    fit_result = dec_fit(iq)
    for _ in range(iters):
        tracked = dec_track(iq)
        d = estimate_sfo(fit_result.rx_sig, cfg_fit,
                         decisions=tracked.rx_data)
        delta_total = delta_total + d
        iq = correct_sfo(iq, d)
        fit_result = dec_fit(iq)
    if cfg_fit == cfg:
        result = fit_result
    else:
        result = rx_mod.make_decoder(cfg, device=device)(iq)
    return result, delta_total, iq
