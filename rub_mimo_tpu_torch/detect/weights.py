"""Detector-weight selection (port of rub_mimo_tpu/detect/weights.py)."""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from rub_mimo_tpu_torch.config import CommMode, Detector, ModemConfig
from rub_mimo_tpu_torch.detect import mmse as mmse_mod
from rub_mimo_tpu_torch.detect import zf as zf_mod
from rub_mimo_tpu_torch.estimate import ls


def weights_for(cfg: ModemConfig, G: torch.Tensor, G_occ: torch.Tensor,
                window: Optional[torch.Tensor] = None,
                ac_index: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(W [m_occ, out, rx], gain [m_occ]) for the configured detector,
    from the occupied-carrier channel G_occ [m_occ, rx, tx] (G itself on
    an all-occupied allocation, else G[occ]).  mmse_auto_noise measures
    sigma^2 from the estimation window, the access-code offsets and the
    full channel G."""
    return weights_from(cfg, G_occ, resolve_noise_var(cfg, G, window,
                                                      ac_index))


def resolve_noise_var(cfg: ModemConfig, G: torch.Tensor,
                      window: Optional[torch.Tensor] = None,
                      ac_index: Optional[torch.Tensor] = None):
    """The sigma^2 the MMSE detector uses: measured from the estimation
    window when mmse_auto_noise, else the configured constant."""
    if cfg.detector == Detector.MMSE and cfg.mmse_auto_noise:
        if window is None or ac_index is None:
            raise ValueError("mmse_auto_noise requires the estimation "
                             "window and access-code offsets")
        return ls.estimate_noise_var(window, ac_index, G, cfg)
    return cfg.mmse_noise_var


def weights_from(cfg: ModemConfig, G_occ: torch.Tensor,
                 noise_var) -> Tuple[torch.Tensor, torch.Tensor]:
    """(W, gain) from the occupied-carrier channel, per subcarrier;
    noise_var is a float or a float32 device scalar.  The SISO,
    RX_DIVERSITY and ALAMOUTI modes and the ML and SIC detectors work on
    the channel directly: zero W and unit gain."""
    S = cfg.num_streams
    m_occ = G_occ.shape[0]
    if cfg.mode in (CommMode.SISO, CommMode.RX_DIVERSITY,
                    CommMode.ALAMOUTI) or cfg.detector in (Detector.ML,
                                                           Detector.SIC):
        return (torch.zeros((m_occ, S, S), dtype=torch.complex64,
                            device=G_occ.device),
                torch.ones((m_occ,), dtype=torch.float32,
                           device=G_occ.device))
    if cfg.detector == Detector.MMSE:
        return mmse_mod.mmse_weights(G_occ, noise_var)
    return zf_mod.invert(G_occ, cfg.invert_to_unity)
