"""Matched-filter timing refinement over the access-code region.

Port of rub_mimo_tpu/sync/matched_filter.py (the "xcorr" method with the
single-device static bases).  The reference FFTs an M-sample window at
every candidate offset and dots it against each sequence
(framing.cc:702-744); since the DFT is unitary up to scale that equals a
time-domain correlation with the sequence's unnormalized inverse FFT, so
each template q is correlated against its own (symbol_len + M)-sample
lane with one FFT.  Values are |corr|^2 / M^2 (framing.cc:716-717).

The template FFT is computed on the host in numpy, as the JAX package
does, so both packages round it identically; it is cached on the device
per config.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import numpy as np
import torch

from rub_mimo_tpu.config import ModemConfig
from rub_mimo_tpu_torch.ofdm import preamble


class MatchedFilterResult(NamedTuple):
    s0_index: torch.Tensor  # int64[streams] — argmax offset for S0
    s0_peak: torch.Tensor   # float32[streams]
    ac_index: torch.Tensor  # int64[streams, codes*streams] — absolute offsets
    ac_peak: torch.Tensor   # float32[streams, codes*streams]


def templates(cfg: ModemConfig) -> np.ndarray:
    """[1 + codes*streams, M] unnormalized time-domain templates: row 0
    is S0, row 1 + code*streams + tx access code (code, tx)
    (framing.cc:724 ordering)."""
    t = preamble.tables(cfg)
    rows = [t.s0_unnormalized]
    for code in range(cfg.num_access_codes):
        for tx in range(cfg.num_streams):
            rows.append(t.s1_unnormalized[tx, code])
    return np.stack(rows).astype(np.complex64)


def _fft_len(n: int) -> int:
    """Next power of two >= n."""
    return 1 << (n - 1).bit_length()


@functools.lru_cache(maxsize=8)
def _template_fft_conj(cfg: ModemConfig, device: torch.device) -> torch.Tensor:
    L = _fft_len(cfg.symbol_len + cfg.M)
    tf = np.conj(np.fft.fft(templates(cfg), n=L, axis=-1))
    return torch.as_tensor(tf.astype(np.complex64), device=device)


def corr_vals(window: torch.Tensor, cfg: ModemConfig) -> torch.Tensor:
    """Correlation magnitudes [streams, n_seq, symbol_len]: |corr|^2/M^2 of
    template q at window offsets q*symbol_len + i, i in [0, symbol_len).

    window: [streams, W] complex, the estimation region (zero-extended to
    symbol_len*n_seq + M when shorter)."""
    sym = cfg.symbol_len
    M = cfg.M
    n_seq = 1 + cfg.num_access_codes * cfg.num_streams
    region_len = sym * n_seq + M
    Lw = sym + M  # row q's offsets plus the template length
    w = window[:, :region_len]
    if w.shape[1] < region_len:
        w = torch.nn.functional.pad(w, (0, region_len - w.shape[1]))
    wins = w.unfold(-1, Lw, sym)  # [S, n_seq, Lw]: lane q starts at q*sym
    Tfc = _template_fft_conj(cfg, window.device)
    Wf = torch.fft.fft(wins, n=Tfc.shape[-1], dim=-1)
    # i + n < sym + M = Lw <= L: the circular lags never wrap
    corr = torch.fft.ifft(Wf * Tfc, dim=-1)[..., :sym]
    return (corr.real ** 2 + corr.imag ** 2) / np.float32(M * M)


def finalize(vals: torch.Tensor, cfg: ModemConfig, *,
             joint: bool) -> MatchedFilterResult:
    """Argmax + absolute-offset bookkeeping over [S, n_seq, sym] vals.

    joint pools correlation energy over all streams and sequences at a
    common base offset (one global argmax, peaks exactly symbol_len
    apart); otherwise each (rx, sequence) takes its own argmax, the
    reference's per-code behaviour (framing.cc:702-744)."""
    S = cfg.num_streams
    sym = cfg.symbol_len
    n_seq = 1 + cfg.num_access_codes * S
    if joint:
        i0 = torch.argmax(vals.sum(dim=(0, 1)))
        i_star = i0.expand(S, n_seq)
    else:
        i_star = torch.argmax(vals, dim=-1)
    peaks = torch.gather(vals, 2, i_star.unsqueeze(-1))[..., 0]
    abs_idx = i_star + torch.arange(n_seq, device=vals.device) * sym
    return MatchedFilterResult(
        s0_index=abs_idx[:, 0], s0_peak=peaks[:, 0],
        ac_index=abs_idx[:, 1:], ac_peak=peaks[:, 1:],
    )


def search(window: torch.Tensor, cfg: ModemConfig, *,
           joint: bool) -> MatchedFilterResult:
    """The (offset, sequence, rx) correlation search over the estimation
    region (starts one symbol before sync_index, framing.cc:284, 639-651)."""
    return finalize(corr_vals(window, cfg), cfg, joint=joint)
