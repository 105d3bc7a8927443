"""Least-squares MIMO channel estimation from the access-code pilots.

Port of rub_mimo_tpu/estimate/ls.py (framing.cc:801-824): for every access
code and (rx, tx) pair, FFT the M-sample window at that code's
matched-filter offset and accumulate

    G[sc][rx][tx] += X_rx[sc] / S1_tx[code][sc]      (occupied sc only)

then scale by dft_normalizer / num_access_codes, dft_normalizer =
1/sqrt(M_occupied).  bit_exact=True keeps the reference's identity bias
(G starts at identity and is never zeroed, framing.cc:302-319).  The
noise-variance helpers are not ported yet.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from rub_mimo_tpu.config import ModemConfig
from rub_mimo_tpu_torch.ofdm import preamble, sctype


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
    W = window.shape[-1]
    starts = torch.clamp(offsets.reshape(-1), 0, W - M)
    rx_ids = torch.arange(S, device=window.device).repeat_interleave(S)
    rx_ids = rx_ids.repeat(n_codes)  # rx varies over the middle axis
    idx = starts.unsqueeze(1) + torch.arange(M, device=window.device)
    wins = window[rx_ids.unsqueeze(1), idx]
    return torch.fft.fft(wins.reshape(n_codes, S, S, M), dim=-1)


@functools.lru_cache(maxsize=8)
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
