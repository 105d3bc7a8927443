"""Per-symbol equalization dispatch (port of rub_mimo_tpu/detect/
dispatch.py): the branch table of the non-sequential modes and
detectors, mode first, then detector.  Alamouti and track_channel stay
in the pipeline: they need cross-symbol structure."""

from __future__ import annotations

import torch

from rub_mimo_tpu_torch.config import CommMode, Detector, ModemConfig
from rub_mimo_tpu_torch.detect import diversity, ml, sic, siso, zf


def equalize_dispatch(Y: torch.Tensor, G_occ: torch.Tensor, W: torch.Tensor,
                      gain: torch.Tensor, cfg: ModemConfig) -> torch.Tensor:
    """Y: [n_sym, S(rx), n_sc] -> eq [n_sym, S(out), n_sc]."""
    if cfg.mode == CommMode.SISO:
        eq = torch.zeros_like(Y)
        eq[:, cfg.siso_rx, :] = siso.siso_equalize(Y, G_occ, cfg.siso_rx,
                                                   cfg.siso_tx)
        return eq
    if cfg.mode == CommMode.RX_DIVERSITY:
        eq = torch.zeros_like(Y)
        eq[:, cfg.siso_tx, :] = diversity.mrc_combine(Y, G_occ, cfg.siso_tx)
        return eq
    if cfg.detector == Detector.ML:
        return ml.ml_equalize(Y, G_occ, cfg)
    if cfg.detector == Detector.SIC:
        return sic.sic_equalize(Y, G_occ, cfg, cfg.mmse_noise_var)
    return zf.equalize(Y, W, gain)
