"""Delay-domain denoising of the LS channel estimate (port of
rub_mimo_tpu/estimate/smooth.py).

A channel whose delay spread fits the cyclic prefix has ~cp_len degrees
of freedom, while the LS estimate is independent per subcarrier.  Ghat is
taken to the delay domain, only the taps a CP-respecting channel can
occupy are kept ([0, cp_len] plus ``margin`` wrap-around taps for timing
jitter), and the result is taken back: about 10 log10(M / (cp_len +
margin)) dB of estimation SNR.  All-carriers allocations only (guard
bands make the delay-domain support leak; config.validate gates it).
"""

from __future__ import annotations

import torch

from rub_mimo_tpu_torch.config import ModemConfig
from rub_mimo_tpu_torch.utils.device_cache import device_constant


@device_constant
def _keep(M: int, cp_len: int, margin: int, device: torch.device):
    keep = torch.zeros(M, dtype=torch.float32)
    keep[: cp_len + 1] = 1.0
    if margin:
        keep[-margin:] = 1.0
    return keep.to(device)[:, None, None]


def smooth_channel_estimate(G: torch.Tensor, cfg: ModemConfig,
                            margin: int = 4) -> torch.Tensor:
    """G [M, rx, tx] complex64 -> the same, low-pass in the delay domain."""
    g_t = torch.fft.ifft(G, dim=0) * _keep(cfg.M, cfg.cp_len, margin,
                                           G.device)
    return torch.fft.fft(g_t, dim=0).to(torch.complex64)
