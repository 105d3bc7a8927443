"""S0 cross-correlation sync fallback for low SNR (port of
rub_mimo_tpu/sync/xcorr_sync.py).

The plateau detector needs the S&C metric above 0.95, whose ceiling is
(SNR/(1+SNR))^2: it cannot acquire below ~16 dB.  The fallback matched-
filters the whole capture against the known S0 time template, normalized
by Cauchy-Schwarz and combined over rx streams in power, which keeps
acquiring tens of dB lower.  With the S0 body at peak p, sync_index =
p + M - cp_len keeps the replay window one symbol ahead of the frame, as
the plateau's index would.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from rub_mimo_tpu_torch.config import ModemConfig
from rub_mimo_tpu_torch.ofdm import preamble
from rub_mimo_tpu_torch.utils.device_cache import device_constant
from rub_mimo_tpu_torch.utils.movsum import moving_sum


class XcorrSyncResult(NamedTuple):
    peak_index: torch.Tensor  # int64 — S0 body start estimate
    sync_index: torch.Tensor  # int64 — plateau-equivalent sync index
    quality: torch.Tensor     # float32 — normalized correlation in [0, 1]


def _fft_len(n: int) -> int:
    return 1 << (n - 1).bit_length()


@device_constant
def _s0_template(cfg: ModemConfig, device: torch.device) -> torch.Tensor:
    """The unnormalized S0 time template on ``device``, made once."""
    return torch.as_tensor(preamble.tables(cfg).s0_unnormalized,
                           device=device)


def normalized_s0_score(ext: torch.Tensor, cfg: ModemConfig,
                        n_pos: int) -> torch.Tensor:
    """score[j] in [0, 1] for the windows ext[:, j : j+M), j < n_pos, of
    ext [streams, >= n_pos + M - 1]:

        score[j] = sum_rx |corr_j|^2 / (sum_rx energy_j * ||s0||^2)

    Windows past ext's end read zeros (FFT padding).  The denominator is
    floored at 1e-2 of the MEDIAN nonzero window energy (the noise level):
    silent windows carry FFT round-trip residue in |corr|^2 that a bare
    epsilon would blow up, while a max-referenced floor would deflate a
    weak burst beside a strong interferer.  An all-zero input has zero
    |corr|^2, and the 1e-20 keeps it 0/eps = 0."""
    M = cfg.M
    tmpl = _s0_template(cfg, ext.device)
    e_tmpl = (tmpl.abs() ** 2).sum()
    L = _fft_len(ext.shape[-1] + M)
    Xf = torch.fft.fft(ext, n=L, dim=-1)
    Tf = torch.fft.fft(tmpl, n=L)
    c = torch.fft.ifft(Xf * torch.conj(Tf), dim=-1)[:, :n_pos]
    c2 = c.real ** 2 + c.imag ** 2
    e_win = moving_sum(ext.real ** 2 + ext.imag ** 2, M)  # ext[i-M+1 .. i]
    e_fwd = torch.roll(e_win, -(M - 1), dims=-1)[:, :n_pos]
    den = e_fwd.sum(dim=0) * e_tmpl
    mx = den.max()
    nz = den > 1e-12 * mx
    n_nz = nz.sum()
    srt = torch.sort(torch.where(nz, den, torch.inf)).values
    med = srt.gather(0, torch.clamp(n_nz // 2, 0, den.shape[-1] - 1)
                     .reshape(1))[0]
    med = torch.where(n_nz > 0, med, mx)
    floor = 1e-2 * med
    return c2.sum(dim=0) / torch.maximum(den, floor + 1e-20)


def s0_xcorr_sync(x: torch.Tensor, cfg: ModemConfig) -> XcorrSyncResult:
    """The normalized S0 matched filter over the whole capture x [S, T],
    the tail where the window runs off the capture excluded."""
    M = cfg.M
    T = x.shape[-1]
    score = normalized_s0_score(x, cfg, T)
    score = torch.where(torch.arange(T, device=x.device) < T - M, score, 0.0)
    p = torch.argmax(score)
    return XcorrSyncResult(peak_index=p, sync_index=p + M - cfg.cp_len,
                           quality=score.gather(0, p.reshape(1))[0])
