"""SISO (single-stream) detection: per-subcarrier scalar division.

Port of rub_mimo_tpu/detect/siso.py (execute_siso_decode,
mimo/framing.cc:508-533): the selected rx stream's frequency-domain
symbols divided by the scalar channel G[sc][siso_rx][siso_tx].
"""

from __future__ import annotations

import torch


def siso_equalize(Y: torch.Tensor, G: torch.Tensor, siso_rx: int,
                  siso_tx: int) -> torch.Tensor:
    """Y: [..., n_streams, n_sc] rx symbols; G: [n_sc, rx, tx].

    Returns [..., n_sc]: Y[siso_rx] / G[:, siso_rx, siso_tx]."""
    g = G[:, siso_rx, siso_tx]
    return (Y[..., siso_rx, :] / g).to(torch.complex64)
