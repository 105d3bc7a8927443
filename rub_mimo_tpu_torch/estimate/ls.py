"""Least-squares MIMO channel estimation from the access-code pilots.

Port of rub_mimo_tpu/estimate/ls.py (framing.cc:801-824): for every access
code and (rx, tx) pair, FFT the M-sample window at that code's
matched-filter offset and accumulate

    G[sc][rx][tx] += X_rx[sc] / S1_tx[code][sc]      (occupied sc only)

then scale by dft_normalizer / num_access_codes, dft_normalizer =
1/sqrt(M_occupied).  bit_exact=True keeps the reference's identity bias
(G starts at identity and is never zeroed, framing.cc:302-319).  The
noise variance at the equalizer input (for ``mmse_auto_noise``) comes
from the same code FFTs.
"""

from __future__ import annotations

import numpy as np
import torch

from rub_mimo_tpu_torch.config import ModemConfig
from rub_mimo_tpu_torch.ofdm import preamble, sctype
from rub_mimo_tpu_torch.utils.device_cache import device_constant
from rub_mimo_tpu_torch.utils.gather import gather_windows


def code_ffts(window: torch.Tensor, offsets: torch.Tensor,
              cfg: ModemConfig) -> torch.Tensor:
    """Unnormalized M-point FFTs of the access-code windows,
    X [codes, S(rx), S(tx), M], from offsets [codes, rx, tx].

    Each window is gathered at its own start, clamped to [0, W - M] like
    the JAX package's dynamic slices.  On the joint-timing grid these
    are the windows of the JAX package's uniform strided span (its TPU
    static-slice path); the gather reads no offsets back to the host."""
    S = cfg.num_streams
    M = cfg.M
    n_codes = offsets.shape[0]
    rx_ids = torch.arange(S, device=window.device).repeat_interleave(S)
    rx_ids = rx_ids.repeat(n_codes)  # rx varies over the middle axis
    wins = gather_windows(window, rx_ids, offsets.reshape(-1), M)
    return torch.fft.fft(wins.reshape(n_codes, S, S, M), dim=-1)


@device_constant
def _s1_and_mask(cfg: ModemConfig, device: torch.device):
    """S1 as [code, 1(rx), tx, M] and the occupied mask, on the device."""
    S1 = preamble.tables(cfg).S1.transpose(1, 0, 2)[:, None, :, :]
    occ = sctype.occupied_mask(sctype.allocation(cfg))
    return (torch.as_tensor(np.ascontiguousarray(S1), device=device),
            torch.as_tensor(occ, device=device))


def channel_from_ffts(X: torch.Tensor, cfg: ModemConfig) -> torch.Tensor:
    """LS estimate [M, rx, tx] complex64 from the full code-FFT batch."""
    S1, occ = _s1_and_mask(cfg, X.device)
    dft_normalizer = np.float32(1.0 / np.sqrt(sctype.m_occupied(cfg)))
    ratio = torch.where(occ, X / torch.where(occ, S1, 1.0), 0.0)
    Gsum = ratio.sum(dim=0).permute(2, 0, 1)  # [M, rx, tx]
    if cfg.bit_exact:
        eye = torch.eye(cfg.num_streams, dtype=Gsum.dtype, device=X.device)
        Gsum = Gsum + eye * occ[:, None, None]
    scale = dft_normalizer / np.float32(cfg.num_access_codes)
    return (Gsum * float(scale)).to(torch.complex64)


def ac_offsets(ac_index: torch.Tensor, cfg: ModemConfig) -> torch.Tensor:
    """[codes, rx, tx] offsets from the matched filter's ac_index:
    offsets[code, rx, tx] = ac_index[rx, code*S + tx] (framing.cc:804-806)."""
    S = cfg.num_streams
    return ac_index.reshape(S, cfg.num_access_codes, S).permute(1, 0, 2)


def estimate_channel(window: torch.Tensor, ac_index: torch.Tensor,
                     cfg: ModemConfig) -> torch.Tensor:
    """LS channel estimate Ghat: [M, num_streams(rx), num_streams(tx)]."""
    X = code_ffts(window, ac_offsets(ac_index, cfg), cfg)
    return channel_from_ffts(X, cfg)


def estimate_noise_var(window: torch.Tensor, ac_index: torch.Tensor,
                       G: torch.Tensor, cfg: ModemConfig) -> torch.Tensor:
    """Data-aided noise variance at the equalizer input (float32 scalar):
    sigma^2 for detect.mmse.mmse_weights (ls.py:154-174 of the JAX
    package)."""
    X = code_ffts(window, ac_offsets(ac_index, cfg), cfg)
    return noise_var_from_ffts(X, G, cfg)


def noise_var_from_ffts(X: torch.Tensor, G: torch.Tensor,
                        cfg: ModemConfig) -> torch.Tensor:
    """Each code FFT over S1 is ~ Ghat sqrt(M_occ) + noise; the residual's
    mean power over the occupied bins, scaled by 1/M_occ to the payload's
    1/sqrt(M_occ) normalization.  The channel-estimation error in the
    residual (order 1/codes) errs on the high side, safe for MMSE."""
    S = cfg.num_streams
    S1, occ = _s1_and_mask(cfg, X.device)
    m_occ = sctype.m_occupied(cfg)
    ratio = X / torch.where(occ, S1, 1.0)  # [code, rx, tx, M]
    mean = G.permute(1, 2, 0)[None] * np.float32(np.sqrt(m_occ))
    resid2 = (ratio - mean).abs() ** 2
    var_f = torch.where(occ, resid2, 0.0).sum() / (
        cfg.num_access_codes * S * S * m_occ)
    return (var_f / m_occ).to(torch.float32)
