"""Synthetic MIMO channel simulator — stands in for the USRP radios.

Port of rub_mimo_tpu/io/simulator.py: seeded flat or FIR MIMO mixing, a
per-element phase drift of a flat channel, a carrier frequency offset, a
sampling-clock offset (SFO, resampled by
utils.resample.resample_bandlimited), a leading delay (timing offset),
trailing silence, AWGN, and the RX front end's IQ imbalance and DC
offset; ``inject_fault`` spoils a capture for recovery tests.  The
channel draw and the drift rates are numpy and equal the JAX package's
for the same seed; the noise comes from a seeded ``torch.Generator`` on
the capture's device, so it does NOT match ``jax.random`` — parity tests
compare the noise-free signal (snr_db=inf) or feed one capture to both
decoders.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from rub_mimo_tpu_torch.config import ModemConfig, check_config
from rub_mimo_tpu_torch.ofdm import framegen
from rub_mimo_tpu_torch.utils import resample


@dataclasses.dataclass(frozen=True)
class ChannelSpec:
    """Synthetic channel parameters."""

    snr_db: float = 30.0
    flat: bool = True
    num_taps: int = 1           # >1 and not flat -> random FIR taps
    delay: int = 1000           # leading samples before the frame
    trailing: int = 2048        # trailing samples after the frame
    cfo_subcarriers: float = 0.0  # CFO in subcarrier-spacing units
    seed: int = 1234
    identity: bool = False      # H = I (loopback)
    diagonal_dominance: float = 2.0  # scales the diagonal of random H
    sfo_ppm: float = 0.0        # sampling-clock offset, parts per million
    # RX front end of a direct-conversion receiver (the B210's AD9361):
    # I/Q arm mismatch, z = mu*y + nu*conj(y), and a residual DC offset
    iq_amp_db: float = 0.0
    iq_phase_deg: float = 0.0
    dc_offset: complex = 0.0
    # per-element phase drift of a flat channel, cycles/sample: each H
    # entry rotates at drift_rate * u, u ~ U(-1, 1)
    drift_rate: float = 0.0


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


def apply_channel(tx: torch.Tensor, h: np.ndarray, spec: ChannelSpec,
                  cfg: Optional[ModemConfig] = None) -> torch.Tensor:
    """Propagate tx [tx_streams, T] through h: returns rx
    [rx_streams, T + delay + trailing + taps - 1] complex64 on tx's
    device: mixed (a flat channel drifting at spec.drift_rate), rotated
    by the CFO (which needs cfg for the subcarrier spacing), resampled at
    t * (1 + sfo_ppm 1e-6), with AWGN at spec.snr_db against the mean tx
    power, then the IQ imbalance and the DC offset."""
    h = torch.as_tensor(h, device=tx.device)
    num_rx, num_tx, taps = h.shape
    T = tx.shape[-1]
    if taps == 1 and spec.drift_rate != 0.0:
        # each element rotates at its own rate, drawn as the JAX package
        # draws it
        rng = np.random.default_rng(spec.seed + 7)
        rates = torch.as_tensor(
            spec.drift_rate * rng.uniform(-1, 1, (num_rx, num_tx)),
            dtype=torch.float32, device=tx.device)
        n = torch.arange(T, dtype=torch.float32, device=tx.device)
        rot = torch.exp(2j * np.pi * rates[..., None] * n)  # [rx, tx, T]
        y = torch.einsum("rtn,tn->rn", h[..., 0, None] * rot, tx)
    elif taps == 1:
        y = torch.einsum("rt,tn->rn", h[..., 0], tx)
    else:  # full linear convolution through one zero-padded FFT
        L = T + taps - 1
        nfft = 1 << (L - 1).bit_length()
        Xf = torch.fft.fft(tx, n=nfft, dim=-1)
        Hf = torch.fft.fft(h, n=nfft, dim=-1)
        y = torch.fft.ifft(torch.einsum("rtn,tn->rn", Hf, Xf), dim=-1)[:, :L]
    if spec.cfo_subcarriers != 0.0:
        if cfg is None:
            raise ValueError("cfo requires cfg for subcarrier spacing")
        n = torch.arange(y.shape[-1], dtype=torch.float32, device=y.device)
        y = y * torch.exp(2j * np.pi * spec.cfo_subcarriers * n / cfg.M)
    if spec.sfo_ppm != 0.0:
        y = resample.resample_bandlimited(y, 1.0 + spec.sfo_ppm * 1e-6)
    y = torch.nn.functional.pad(y, (spec.delay, spec.trailing))

    sig_power = torch.mean(tx.real ** 2 + tx.imag ** 2)
    noise_var = sig_power * 10.0 ** (-spec.snr_db / 10.0)
    gen = torch.Generator(device=tx.device).manual_seed(spec.seed + 1)
    nr = torch.randn(y.shape, generator=gen, device=tx.device)
    ni = torch.randn(y.shape, generator=gen, device=tx.device)
    noise = torch.sqrt(noise_var / 2.0) * torch.complex(nr, ni)
    y = (y + noise).to(torch.complex64)

    if spec.iq_amp_db != 0.0 or spec.iq_phase_deg != 0.0:
        g = 10.0 ** (spec.iq_amp_db / 20.0)
        phi = np.deg2rad(spec.iq_phase_deg)
        mu = complex(np.complex64((1.0 + g * np.exp(1j * phi)) / 2.0))
        nu = complex(np.complex64((1.0 - g * np.exp(-1j * phi)) / 2.0))
        y = (mu * y + nu * torch.conj(y)).to(torch.complex64)
    if spec.dc_offset != 0.0:
        y = y + complex(np.complex64(spec.dc_offset))
    return y


def inject_fault(capture: np.ndarray, kind: str, *, seed: int = 0,
                 position: float = 0.5, length: int = 256) -> np.ndarray:
    """A spoiled copy of a numpy capture for recovery tests: 'truncate'
    (cut at the ``position`` fraction), 'nan_burst' (``length`` NaN
    samples there), 'dropout' (``length`` zeros) or 'spike' (one sample
    of 1e6).  ``seed`` is unused, as in the JAX package."""
    x = np.array(capture, copy=True)
    pos = int(x.shape[-1] * position)
    if kind == "truncate":
        return x[..., :pos]
    if kind == "nan_burst":
        x[..., pos:pos + length] = np.nan
        return x
    if kind == "dropout":
        x[..., pos:pos + length] = 0
        return x
    if kind == "spike":
        x[..., pos] = 1e6
        return x
    raise ValueError(f"unknown fault kind {kind!r}")


def simulate_capture(cfg: ModemConfig, spec: ChannelSpec,
                     tx_data: Optional[np.ndarray] = None,
                     payload_seed: int = 0, *, device):
    """End-to-end synthetic experiment: (capture, tx_data, h).

    capture: [num_streams, T] complex64 tensor on ``device``
    tx_data: [num_streams, pid_max * M_occupied] int32 ground truth (numpy)
    h:       [rx, tx, taps] channel realization (numpy)
    """
    check_config(cfg, "simulator.simulate_capture")
    if tx_data is None:
        tx_data = framegen.generate_payload_symbols(cfg, seed=payload_seed)
    h = draw_channel(spec, cfg.num_streams, cfg.num_streams)
    tx = framegen.transmit_frame(cfg, tx_data, device=device)
    return apply_channel(tx, h, spec, cfg), tx_data, h
