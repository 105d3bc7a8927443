"""Alamouti space-time block coding over two TX antennas.

Port of rub_mimo_tpu/detect/alamouti.py.  Per subcarrier, symbol pairs
(s0, s1) ride two consecutive OFDM symbols:

    time t:    antenna0 -> s0          antenna1 -> s1
    time t+1:  antenna0 -> -conj(s1)   antenna1 -> conj(s0)

and the receiver combines, over its rx antennas,

    s0_hat = sum_rx [ conj(h0) r_t + h1 conj(r_{t+1}) ] / E
    s1_hat = sum_rx [ conj(h1) r_t - h0 conj(r_{t+1}) ] / E
    E      = sum_rx ( |h0|^2 + |h1|^2 ).

The payload rides one logical stream; pid_max must be even.
"""

from __future__ import annotations

import torch


def encode_pairs(sym: torch.Tensor) -> torch.Tensor:
    """sym: [n_sym, n_sc] (n_sym even) -> [2 (antenna), n_sym, n_sc]."""
    n_sym, n_sc = sym.shape
    s0, s1 = sym[0::2], sym[1::2]
    ant0 = torch.stack([s0, -torch.conj(s1)], dim=1).reshape(n_sym, n_sc)
    ant1 = torch.stack([s1, torch.conj(s0)], dim=1).reshape(n_sym, n_sc)
    return torch.stack([ant0, ant1]).to(torch.complex64)


def combine_pairs(Y: torch.Tensor, G_occ: torch.Tensor) -> torch.Tensor:
    """Y: [n_sym, n_rx, n_sc] (n_sym even); G_occ: [n_sc, n_rx, 2].
    Returns the decoded stream [n_sym, n_sc], pair-interleaved."""
    n_sym, _, n_sc = Y.shape
    r0, r1 = Y[0::2], Y[1::2]               # [P, rx, sc]
    h0 = G_occ[:, :, 0].T[None]             # [1, rx, sc]
    h1 = G_occ[:, :, 1].T[None]
    e = torch.sum(G_occ[:, :, 0].abs() ** 2 + G_occ[:, :, 1].abs() ** 2,
                  dim=1)                    # [sc]
    s0 = torch.sum(torch.conj(h0) * r0 + h1 * torch.conj(r1), dim=1) / e
    s1 = torch.sum(torch.conj(h1) * r0 - h0 * torch.conj(r1), dim=1) / e
    return torch.stack([s0, s1], dim=1).reshape(n_sym, n_sc).to(
        torch.complex64)
