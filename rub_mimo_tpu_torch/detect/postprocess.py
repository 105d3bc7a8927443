"""Equalizer-output postprocessing (port of rub_mimo_tpu/detect/
postprocess.py): the normalize_rx_scale compensation and the
decision-directed common-phase tracking."""

from __future__ import annotations

import numpy as np
import torch

from rub_mimo_tpu_torch.config import ModemConfig
from rub_mimo_tpu_torch.ofdm import constellation


def postprocess_eq(eq: torch.Tensor, cfg: ModemConfig) -> torch.Tensor:
    """eq: [..., n_sc] equalized symbols, the last axis the occupied
    carriers.  normalize_rx_scale multiplies by sqrt(M_occupied/M) when
    guard bands are on; track_phase demaps (the K4 kernel on CUDA),
    measures each row's common phase against its decisions and
    de-rotates it."""
    m_occ = cfg.M_occupied
    if cfg.normalize_rx_scale and m_occ != cfg.M:
        eq = eq * float(np.float32(np.sqrt(m_occ / cfg.M)))
    if cfg.track_phase:
        d1 = constellation.demodulate(eq, cfg.modulation)
        ideal = constellation.table_on(cfg.modulation, eq.device)[d1.long()]
        rot = torch.sum(eq * torch.conj(ideal), dim=-1)
        eq = eq * torch.exp(-1j * torch.angle(rot))[..., None]
    return eq.to(torch.complex64)
