"""Receive diversity (maximum-ratio combining), MODE_RX_DIVERSITY.

Port of rub_mimo_tpu/detect/diversity.py: one TX stream received on all
antennas, combined per subcarrier as

    xhat[sc] = sum_r conj(g_r[sc]) y_r[sc] / sum_r |g_r[sc]|^2
"""

from __future__ import annotations

import torch


def mrc_combine(Y: torch.Tensor, G_occ: torch.Tensor,
                tx_stream: int) -> torch.Tensor:
    """Y: [..., n_rx, n_sc]; G_occ: [n_sc, rx, tx] -> [..., n_sc]."""
    g = G_occ[:, :, tx_stream]  # [n_sc, rx]
    denom = torch.sum(g.real ** 2 + g.imag ** 2, dim=-1)  # [n_sc]
    num = torch.einsum("sr,...rs->...s", torch.conj(g), Y)
    return (num / denom).to(torch.complex64)
