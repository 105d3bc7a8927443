"""Detector-weight selection (port of rub_mimo_tpu/detect/weights.py for
the linear detectors of the RX_ZF mode)."""

from __future__ import annotations

from typing import Tuple

import torch

from rub_mimo_tpu.config import CommMode, Detector, ModemConfig
from rub_mimo_tpu_torch.detect import mmse as mmse_mod
from rub_mimo_tpu_torch.detect import zf as zf_mod


def weights_for(cfg: ModemConfig,
                G_occ: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(W [m_occ, out, rx], gain [m_occ]) for the configured detector.
    The estimated-noise MMSE (mmse_auto_noise) is not ported yet."""
    if cfg.detector == Detector.MMSE and cfg.mmse_auto_noise:
        raise NotImplementedError("mmse_auto_noise is not ported yet")
    return weights_from(cfg, G_occ, cfg.mmse_noise_var)


def weights_from(cfg: ModemConfig, G_occ: torch.Tensor,
                 noise_var: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """(W, gain) from the occupied-carrier channel, per subcarrier."""
    if cfg.mode != CommMode.RX_ZF or cfg.detector not in (Detector.ZF,
                                                          Detector.MMSE):
        raise NotImplementedError(
            f"weights for mode {cfg.mode.value} / detector "
            f"{cfg.detector.value} are not ported yet")
    if cfg.detector == Detector.MMSE:
        return mmse_mod.mmse_weights(G_occ, noise_var)
    return zf_mod.invert(G_occ, cfg.invert_to_unity)
