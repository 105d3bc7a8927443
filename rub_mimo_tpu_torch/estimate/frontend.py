"""Blind RX front-end compensation: DC offset and IQ imbalance.

Port of rub_mimo_tpu/estimate/frontend.py.  A direct-conversion receiver
distorts the baseband as

    z = mu * y + nu * conj(y) + dc

The conjugate term folds subcarrier -k onto k at the image-rejection
ratio |nu/mu|.  The OFDM waveform is circular (E[y] = 0, E[y^2] = 0), so
both effects follow from second-order moments of the capture:

    dc  = E[z]
    w   = E[z'^2] / ( E[|z'|^2] + sqrt(E[|z'|^2]^2 - |E[z'^2]|^2) )

with z' = z - dc.  For the mu/nu model w equals nu / conj(mu) exactly, so
y = z' - w conj(z') cancels the image; the remaining mu scaling is
absorbed by the channel estimate.  AWGN is circular and biases neither
moment.

Plain tensor code on the capture's device: three reductions and one
elementwise pass, nothing read back to the host.
"""

from __future__ import annotations

from typing import Tuple

import torch

from rub_mimo_tpu_torch.utils.device import on_device


def estimate_frontend(iq: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-stream (dc [S] complex64, w [S] complex64) of [S, T] IQ, on
    iq's device."""
    dc = torch.mean(iq, dim=-1)
    z = iq - dc[:, None]
    c2 = torch.mean(z * z, dim=-1)                 # E[z^2]
    c1 = torch.mean(torch.abs(z) ** 2, dim=-1)     # E[|z|^2]
    root = torch.sqrt(torch.clamp(c1 * c1 - torch.abs(c2) ** 2, min=0.0))
    w = c2 / (c1 + root)
    return dc.to(torch.complex64), w.to(torch.complex64)


def compensate(iq: torch.Tensor, dc: torch.Tensor,
               w: torch.Tensor) -> torch.Tensor:
    """Undo the front end: (z - dc) - w conj(z - dc), per stream."""
    z = iq - dc[:, None]
    return (z - w[:, None] * torch.conj(z)).to(torch.complex64)


def decode_with_frontend(iq, cfg, *, device):
    """Blind front-end compensation on ``device``, then the standard
    decode (rx.make_decoder).  Returns (DecodeResult, dc, w)."""
    from rub_mimo_tpu_torch.pipeline import rx

    dec = rx.make_decoder(cfg, device=device)
    iq = torch.as_tensor(iq, dtype=torch.complex64, device=on_device(device))
    dc, w = estimate_frontend(iq)
    return dec(compensate(iq, dc, w)), dc, w
