"""Detector-weight selection (port of rub_mimo_tpu/detect/weights.py for
the linear detectors of the RX_ZF mode)."""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from rub_mimo_tpu.config import CommMode, Detector, ModemConfig
from rub_mimo_tpu_torch.detect import mmse as mmse_mod
from rub_mimo_tpu_torch.detect import zf as zf_mod
from rub_mimo_tpu_torch.estimate import ls


def weights_for(cfg: ModemConfig, G: torch.Tensor,
                window: Optional[torch.Tensor] = None,
                ac_index: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(W [m_occ, out, rx], gain [m_occ]) for the configured detector, on
    an all-occupied allocation (G is its own occupied-carrier channel).
    mmse_auto_noise needs the estimation window and the access-code
    offsets to measure sigma^2."""
    return weights_from(cfg, G, resolve_noise_var(cfg, G, window, ac_index))


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
    noise_var is a float or a float32 device scalar."""
    if cfg.mode != CommMode.RX_ZF or cfg.detector not in (Detector.ZF,
                                                          Detector.MMSE):
        raise NotImplementedError(
            f"weights for mode {cfg.mode.value} / detector "
            f"{cfg.detector.value} are not ported yet")
    if cfg.detector == Detector.MMSE:
        return mmse_mod.mmse_weights(G_occ, noise_var)
    return zf_mod.invert(G_occ, cfg.invert_to_unity)
