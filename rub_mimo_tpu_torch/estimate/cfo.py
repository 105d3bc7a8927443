"""Carrier-frequency-offset estimation, coarse and residual (port of
rub_mimo_tpu/estimate/cfo.py).

  coarse   — the Schmidl&Cox correlation phase at the sync point
             (sync.schmidl_cox.synchronize), or, when sync came from the
             S0 cross-correlation fallback, the S0 halves at the matched
             filter's S0 offset (``s0_halves_cfo``): angle(P)/pi
             subcarrier units, unambiguous to +/-1 spacing.
  residual — the phase progression of the access-code correlation peaks
             (``residual_cfo``): consecutive codes of one TX stream sit
             num_streams*symbol_len samples apart, so a residual eps
             advances their phase by 2 pi eps num_streams symbol_len / M.

The reference never corrects CFO (the FIXME at framing.cc:486).
"""

from __future__ import annotations

import numpy as np
import torch

from rub_mimo_tpu_torch.config import ModemConfig
from rub_mimo_tpu_torch.ofdm import preamble
from rub_mimo_tpu_torch.utils.device_cache import device_constant
from rub_mimo_tpu_torch.utils.gather import gather_windows


@device_constant
def _code_templates(cfg: ModemConfig, device: torch.device):
    """(rx ids [S*codes*S], conj templates [S*codes*S, M]) for the flat
    (rx, code, tx) order of ac_index."""
    S, codes = cfg.num_streams, cfg.num_access_codes
    rx_ids = np.repeat(np.arange(S), codes * S)
    code_ids = np.tile(np.repeat(np.arange(codes), S), S)
    tx_ids = np.tile(np.arange(S), S * codes)
    tmpl = np.conj(preamble.tables(cfg).s1_unnormalized[tx_ids, code_ids])
    return (torch.as_tensor(rx_ids, device=device),
            torch.as_tensor(tmpl.astype(np.complex64), device=device))


def access_code_peak_phasors(window: torch.Tensor, ac_index: torch.Tensor,
                             cfg: ModemConfig) -> torch.Tensor:
    """Correlation at each access-code peak: [rx, codes, tx] complex64,
    sum_n w[off + n] conj(tmpl[tx][code][n]) with window [streams, W] and
    ac_index [rx, codes*streams] window offsets."""
    S = cfg.num_streams
    rx_ids, tmpl_c = _code_templates(cfg, window.device)
    wins = gather_windows(window, rx_ids, ac_index.reshape(-1), cfg.M)
    return (tmpl_c * wins).sum(dim=-1).reshape(S, cfg.num_access_codes, S)


def s0_halves_cfo(window: torch.Tensor, s0_index: torch.Tensor,
                  cfg: ModemConfig) -> torch.Tensor:
    """Coarse CFO (subcarrier units, float32 scalar) from the S0 symbol's
    repeated halves at the matched filter's S0 offsets s0_index [S]:
    angle(sum over rx of sum_n conj(w[p+n]) w[p+M/2+n]) / pi."""
    M2 = cfg.M // 2
    rows = torch.arange(cfg.num_streams, device=window.device)
    segs = gather_windows(window, rows, s0_index, cfg.M)
    ps = (torch.conj(segs[:, :M2]) * segs[:, M2:]).sum(dim=-1)
    return (torch.angle(ps.sum()) / np.pi).to(torch.float32)


def residual_cfo(window: torch.Tensor, ac_index: torch.Tensor,
                 cfg: ModemConfig) -> torch.Tensor:
    """Residual CFO (subcarrier units, float32 scalar) from the
    code-to-code advance of the peak phases, averaged over every (rx,
    code, tx) pair."""
    S = cfg.num_streams
    ph = access_code_peak_phasors(window, ac_index, cfg)
    step = (ph[:, 1:, :] * torch.conj(ph[:, :-1, :])).sum()
    eps = torch.angle(step) * cfg.M / (2.0 * np.pi * S * cfg.symbol_len)
    return eps.to(torch.float32)
