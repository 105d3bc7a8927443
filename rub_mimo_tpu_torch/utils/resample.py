"""Fractional resampling for the sampling-clock offset (SFO).

Port of rub_mimo_tpu/utils/resample.py, on the input's device:

- resample_linear: one gather and a linear blend.  Its gain at Nyquist is
  cos(pi/2) = 0, so it erases the band edges of an all-carriers OFDM
  waveform.
- resample_bandlimited: exact FFT 4x upsampling (zero-stuffed spectrum,
  the Nyquist bin split for even T), then Catmull-Rom cubic
  interpolation on the dense grid.  The SFO paths use this one.
- StreamingResampler: the chunked form with a carried fractional
  position, for the streaming decoder's live SFO correction.

The FFTs take the input's length as it is (torch.fft); the JAX package
pads to a 5-smooth length only on the TPU backend.  Positions are
float32, computed as t + t * (factor - 1) so the fraction keeps float32
resolution at t in the millions, exactly as the JAX package rounds them.
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np
import torch

from rub_mimo_tpu_torch.utils.device import on_device
from rub_mimo_tpu_torch.utils.device_cache import device_constant


@device_constant
def _ramp(n: int, dtype: torch.dtype, device: torch.device) -> torch.Tensor:
    """[n] 0, 1, ..., n - 1 on ``device``, made once."""
    return torch.arange(n, dtype=dtype, device=device)


def _scalar(x, device: torch.device) -> torch.Tensor:
    """x as a float32 scalar on ``device``: a tensor converted, a Python
    number rounded to float32 and filled in there (no upload)."""
    if isinstance(x, torch.Tensor):
        return x.to(device=device, dtype=torch.float32)
    return torch.full((), float(np.float32(x)), dtype=torch.float32,
                      device=device)


def resample_linear(x: torch.Tensor, factor) -> torch.Tensor:
    """x [..., T] (complex64 or float32) evaluated at t * factor, t = 0 ..
    T-1, by linear interpolation; positions past the end clamp to the
    last sample."""
    T = x.shape[-1]
    t = _ramp(T, torch.float32, x.device)
    off = t * (_scalar(factor, x.device) - 1.0)  # small for ~ppm
    shift = torch.floor(off)
    frac = off - shift
    i0 = torch.clamp(_ramp(T, torch.int64, x.device) + shift.long(), 0, T - 1)
    i1 = torch.clamp(i0 + 1, max=T - 1)
    a = x.index_select(-1, i0)
    b = x.index_select(-1, i1)
    return (a + (b - a) * frac).to(x.dtype)


def _fft_upsample(x: torch.Tensor, up: int) -> torch.Tensor:
    """Band-limited upsampling by the integer ``up``: zero-stuff the
    spectrum, splitting the Nyquist bin symmetrically for even T."""
    T = x.shape[-1]
    X = torch.fft.fft(x.to(torch.complex64), dim=-1)
    h = T // 2
    if T % 2 == 0:
        nyq = X[..., h:h + 1] * 0.5
        mid = torch.zeros(x.shape[:-1] + (up * T - T - 1,), dtype=X.dtype,
                          device=X.device)
        Xu = torch.cat([X[..., :h], nyq, mid, nyq, X[..., h + 1:]], dim=-1)
    else:
        mid = torch.zeros(x.shape[:-1] + (up * T - T,), dtype=X.dtype,
                          device=X.device)
        Xu = torch.cat([X[..., :h + 1], mid, X[..., h + 1:]], dim=-1)
    return torch.fft.ifft(Xu, dim=-1) * up


def _catmull_rom(xu: torch.Tensor, i1: torch.Tensor, frac: torch.Tensor
                 ) -> torch.Tensor:
    """The cubic through xu[i1 - 1 .. i1 + 2] (indices clamped into xu) at
    the fraction ``frac`` past i1."""
    last = xu.shape[-1] - 1
    p0, p1, p2, p3 = (xu.index_select(-1, torch.clamp(i1 + d, 0, last))
                      for d in (-1, 0, 1, 2))
    u = frac
    c0 = -0.5 * u * (1 - u) * (1 - u)
    c1 = 1 + u * u * (1.5 * u - 2.5)
    c2 = u * (0.5 + u * (2.0 - 1.5 * u))
    c3 = 0.5 * u * u * (u - 1)
    return p0 * c0 + p1 * c1 + p2 * c2 + p3 * c3


def resample_bandlimited(x: torch.Tensor, factor) -> torch.Tensor:
    """x [..., T] evaluated at t * factor with band-limited accuracy: FFT
    4x upsampling, then Catmull-Rom on the dense grid.  factor is a
    Python number or a float32 scalar tensor (read on the device, never
    on the host); meant for |factor - 1| at ppm to 1e-3 scale."""
    up = 4
    T = x.shape[-1]
    xu = _fft_upsample(x, up)                              # [..., 4T]
    t = _ramp(T, torch.float32, x.device)
    # dense-grid positions 4 t factor: 4t exact, the correction small
    off = t * (_scalar(factor, x.device) - 1.0) * up
    shift = torch.floor(off)
    frac = off - shift                                     # in [0, 1)
    i1 = _ramp(T, torch.int64, x.device) * up + shift.long()
    out = _catmull_rom(xu, i1, frac)
    if not x.is_complex():
        out = out.real
    return out.to(x.dtype)


class StreamingResampler:
    """Chunked band-limited resampler with a carried position, the live
    form of resample_bandlimited (the streaming decoder's sfo_correct).

    Input arrives in [S, C] chunks; output sample n is the input at a
    cursor q that advances by ``factor`` per output sample (host float64),
    so set_factor retunes mid-stream with no position jump.  Each output
    chunk interpolates an FFT-4x-upsampled window of the input ring, with
    ``margin`` guard samples on each side absorbing the window's periodic
    extension.  ``origin`` is the global position where the resampler
    takes over a stream already consumed raw (input and output positions
    coincide there).  The ring lives on ``device``, which has no default,
    as at every entry point of the port (a CUDA request without CUDA
    raises)."""

    def __init__(self, n_streams: int, chunk_size: int, factor: float = 1.0,
                 margin: int = 256, origin: int = 0, *, device):
        self.S = int(n_streams)
        self.C = int(chunk_size)
        self.margin = int(margin)
        self.factor = float(factor)
        self.origin = int(origin)
        self.device = on_device(device)
        self.L = self.C + 2 * self.margin + 16
        self.R = 3 * self.C + 8 * self.margin + 64
        self._ring = torch.zeros((self.S, self.R), dtype=torch.complex64,
                                 device=self.device)
        self._in_end = int(origin)    # input samples received (global)
        self._q = float(origin)       # input-position cursor

    def set_factor(self, factor: float) -> None:
        """Retune the ratio from the next output sample on (the cursor is
        continuous across the change)."""
        self.factor = float(factor)

    def _chunk(self, chunk) -> torch.Tensor:
        if tuple(chunk.shape) != (self.S, self.C):
            raise ValueError(f"chunk must be [{self.S}, {self.C}]")
        return torch.as_tensor(chunk, dtype=torch.complex64,
                               device=self.device)

    def _write(self, chunk: torch.Tensor, gpos: int) -> None:
        """Input sample g goes to ring slot g % R (one or two slices)."""
        w = gpos % self.R
        first = min(self.C, self.R - w)
        self._ring[:, w:w + first] = chunk[:, :first]
        if first < self.C:
            self._ring[:, :self.C - first] = chunk[:, first:]

    def _window(self, start: int) -> torch.Tensor:
        """The L ring samples from global position ``start``."""
        w = start % self.R
        if w + self.L <= self.R:
            return self._ring[:, w:w + self.L]
        return torch.cat([self._ring[:, w:],
                          self._ring[:, :w + self.L - self.R]], dim=-1)

    def preload_history(self, chunk, gpos: int) -> None:
        """Write an already received [S, C] chunk at [gpos, gpos + C),
        before the origin, so the first output window interpolates real
        history instead of zeros."""
        self._write(self._chunk(chunk), gpos)

    def push(self, chunk, _mask_beyond: Optional[int] = None
             ) -> List[torch.Tensor]:
        """Feed one [S, C] input chunk; returns the [S, C] output chunks
        now complete."""
        self._write(self._chunk(chunk), self._in_end)
        self._in_end += self.C
        return self._drain(_mask_beyond)

    def flush(self) -> List[torch.Tensor]:
        """Zero-pad the input until every output sample whose position
        lies within the real input is out.  Outputs past the real input
        are exact zeros: the window's sinc ringing into the padding would
        read as a Schmidl&Cox plateau downstream."""
        real_end = self._in_end
        zero = torch.zeros((self.S, self.C), dtype=torch.complex64,
                           device=self.device)
        out: List[torch.Tensor] = []
        for _ in range(2 + self.L // self.C):
            out += self.push(zero, _mask_beyond=real_end)
        return out

    def _drain(self, mask_beyond: Optional[int]) -> List[torch.Tensor]:
        out: List[torch.Tensor] = []
        while True:
            win_start = int(np.floor(self._q)) - self.margin
            if win_start + self.L > self._in_end:
                break
            rel0 = self._q - win_start  # in [margin, margin + 1)
            chunk = self._resample_window(self._window(win_start), rel0)
            if mask_beyond is not None:
                # outputs whose input position q + j f is still real input
                n_real = int(np.clip(np.ceil((mask_beyond - self._q)
                                             / self.factor), 0, self.C))
                if n_real < self.C:
                    chunk[:, n_real:] = 0
            out.append(chunk)
            self._q += self.C * self.factor
        return out

    def _resample_window(self, window: torch.Tensor, rel0: float
                         ) -> torch.Tensor:
        """C outputs from the window: output j sits at window-relative
        input position rel0 + j + j (factor - 1)."""
        up, C, dev = 4, self.C, self.device
        xu = _fft_upsample(window, up)  # [S, up L]
        j = _ramp(C, torch.float32, dev)
        off = (_scalar(rel0, dev) + j * _scalar(self.factor - 1.0, dev)) * up
        shift = torch.floor(off)
        frac = off - shift
        i1 = _ramp(C, torch.int64, dev) * up + shift.long()
        return _catmull_rom(xu, i1, frac).to(torch.complex64)
