"""Synthetic MIMO channel simulator — stands in for the USRP radios.

Port of rub_mimo_tpu/io/simulator.py: seeded flat or FIR MIMO mixing, a
leading delay (timing offset), trailing silence and AWGN.  The channel
draw is numpy and gives the same ``h`` as the JAX package for the same
seed; the noise comes from a seeded ``torch.Generator`` on the capture's
device, so it does NOT match ``jax.random`` — parity tests compare the
noise-free signal (snr_db=inf) or feed one capture to both decoders.
CFO, SFO, IQ imbalance, DC offset and drift are not ported yet.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from rub_mimo_tpu.config import ModemConfig
from rub_mimo_tpu_torch.ofdm import framegen


@dataclasses.dataclass(frozen=True)
class ChannelSpec:
    """Synthetic channel parameters (the ported subset)."""

    snr_db: float = 30.0
    flat: bool = True
    num_taps: int = 1           # >1 and not flat -> random FIR taps
    delay: int = 1000           # leading samples before the frame
    trailing: int = 2048        # trailing samples after the frame
    seed: int = 1234
    identity: bool = False      # H = I (loopback)
    diagonal_dominance: float = 2.0  # scales the diagonal of random H


def draw_channel(spec: ChannelSpec, num_rx: int, num_tx: int) -> np.ndarray:
    """Channel impulse response h[rx, tx, taps] (complex64, numpy)."""
    rng = np.random.default_rng(spec.seed)
    taps = 1 if spec.flat else spec.num_taps
    if spec.identity:
        h = np.zeros((num_rx, num_tx, taps), dtype=np.complex64)
        for i in range(min(num_rx, num_tx)):
            h[i, i, 0] = 1.0
        return h
    h = (
        rng.standard_normal((num_rx, num_tx, taps))
        + 1j * rng.standard_normal((num_rx, num_tx, taps))
    ) / np.sqrt(2.0)
    if taps > 1:  # exponentially decaying power-delay profile
        pdp = np.exp(-np.arange(taps) / max(taps / 3.0, 1.0))
        h *= np.sqrt(pdp / pdp.sum())
    for i in range(min(num_rx, num_tx)):
        h[i, i, 0] *= spec.diagonal_dominance
    return h.astype(np.complex64)


def apply_channel(tx: torch.Tensor, h: np.ndarray,
                  spec: ChannelSpec) -> torch.Tensor:
    """Propagate tx [tx_streams, T] through h: returns rx
    [rx_streams, T + delay + trailing + taps - 1] complex64 on tx's
    device, with AWGN at spec.snr_db against the mean tx power."""
    h = torch.as_tensor(h, device=tx.device)
    taps = h.shape[-1]
    T = tx.shape[-1]
    if taps == 1:
        y = torch.einsum("rt,tn->rn", h[..., 0], tx)
    else:  # full linear convolution through one zero-padded FFT
        L = T + taps - 1
        nfft = 1 << (L - 1).bit_length()
        Xf = torch.fft.fft(tx, n=nfft, dim=-1)
        Hf = torch.fft.fft(h, n=nfft, dim=-1)
        y = torch.fft.ifft(torch.einsum("rtn,tn->rn", Hf, Xf), dim=-1)[:, :L]
    y = torch.nn.functional.pad(y, (spec.delay, spec.trailing))

    sig_power = torch.mean(tx.real ** 2 + tx.imag ** 2)
    noise_var = sig_power * 10.0 ** (-spec.snr_db / 10.0)
    gen = torch.Generator(device=tx.device).manual_seed(spec.seed + 1)
    nr = torch.randn(y.shape, generator=gen, device=tx.device)
    ni = torch.randn(y.shape, generator=gen, device=tx.device)
    noise = torch.sqrt(noise_var / 2.0) * torch.complex(nr, ni)
    return (y + noise).to(torch.complex64)


def simulate_capture(cfg: ModemConfig, spec: ChannelSpec,
                     tx_data: Optional[np.ndarray] = None,
                     payload_seed: int = 0, *, device):
    """End-to-end synthetic experiment: (capture, tx_data, h).

    capture: [num_streams, T] complex64 tensor on ``device``
    tx_data: [num_streams, pid_max * M_occupied] int32 ground truth (numpy)
    h:       [rx, tx, taps] channel realization (numpy)
    """
    if tx_data is None:
        tx_data = framegen.generate_payload_symbols(cfg, seed=payload_seed)
    h = draw_channel(spec, cfg.num_streams, cfg.num_streams)
    tx = framegen.transmit_frame(cfg, tx_data, device=device)
    return apply_channel(tx, h, spec), tx_data, h
