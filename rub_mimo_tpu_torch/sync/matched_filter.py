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
from typing import NamedTuple, Optional

import numpy as np
import torch

from rub_mimo_tpu_torch.config import ModemConfig
from rub_mimo_tpu_torch.ofdm import preamble
from rub_mimo_tpu_torch.utils.device_cache import device_constant


class MatchedFilterResult(NamedTuple):
    s0_index: torch.Tensor  # int64[streams] — argmax offset for S0
    s0_peak: torch.Tensor   # float32[streams]
    ac_index: torch.Tensor  # int64[streams, codes*streams] — absolute offsets
    ac_peak: torch.Tensor   # float32[streams, codes*streams]
    traces: Optional[torch.Tensor] = None  # float32[streams, n_seq, sym]


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


@device_constant
def _template_fft_conj(cfg: ModemConfig, device: torch.device) -> torch.Tensor:
    L = _fft_len(cfg.symbol_len + cfg.M)
    tf = np.conj(np.fft.fft(templates(cfg), n=L, axis=-1))
    return torch.as_tensor(tf.astype(np.complex64), device=device)


@functools.lru_cache(maxsize=32)
def template_chunk(cfg: ModemConfig, start: int, length: int,
                   device: torch.device):
    """Rows [start, start + length) of the template set, as ``corr_vals``
    takes a chunk: (conj template FFTs [length, L], base offsets [length]
    = sequence index * symbol_len).  Rows past the last sequence are zero
    templates at base 0 (the padding of an uneven split)."""
    full = _template_fft_conj(cfg, device)
    n_seq = full.shape[0]
    rows = torch.zeros((length, full.shape[1]), dtype=full.dtype,
                       device=device)
    real = max(0, min(n_seq - start, length))
    rows[:real] = full[start:start + real]
    base = torch.zeros((length,), dtype=torch.int64, device=device)
    base[:real] = torch.arange(start, start + real, device=device) \
        * cfg.symbol_len
    return rows, base


def corr_vals(window: torch.Tensor, cfg: ModemConfig,
              tmpl_fft: Optional[torch.Tensor] = None,
              seq_base: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Correlation magnitudes [streams, n_tmpl, symbol_len]: |corr|^2/M^2 of
    template q at window offsets seq_base[q] + i, i in [0, symbol_len).

    window: [streams, W] complex, the estimation region (zero-extended to
    symbol_len*n_seq + M when shorter).  By default every template, row q
    at base q*symbol_len; a chunk of them (``template_chunk``: their conj
    FFTs and bases) gives those rows alone, each the same as in the full
    set (the sharded decode splits the templates over its "sc" axis)."""
    sym = cfg.symbol_len
    M = cfg.M
    n_seq = 1 + cfg.num_access_codes * cfg.num_streams
    region_len = sym * n_seq + M
    Lw = sym + M  # row q's offsets plus the template length
    w = window[:, :region_len]
    if w.shape[1] < region_len:
        w = torch.nn.functional.pad(w, (0, region_len - w.shape[1]))
    if tmpl_fft is None:
        wins = w.unfold(-1, Lw, sym)  # [S, n_seq, Lw]: lane q at q*sym
        Tfc = _template_fft_conj(cfg, window.device)
    else:
        idx = seq_base.unsqueeze(1) + torch.arange(Lw, device=w.device)
        wins = w[:, idx]  # [S, n_tmpl, Lw]
        Tfc = tmpl_fft
    Wf = torch.fft.fft(wins, n=Tfc.shape[-1], dim=-1)
    # i + n < sym + M = Lw <= L: the circular lags never wrap
    corr = torch.fft.ifft(Wf * Tfc, dim=-1)[..., :sym]
    return (corr.real ** 2 + corr.imag ** 2) / np.float32(M * M)


def finalize(vals: torch.Tensor, cfg: ModemConfig, *, joint: bool,
             keep_traces: bool = False) -> MatchedFilterResult:
    """Argmax + absolute-offset bookkeeping over [S, n_seq, sym] vals.

    joint pools correlation energy over all streams and sequences at a
    common base offset (one global argmax, peaks exactly symbol_len
    apart); otherwise each (rx, sequence) takes its own argmax, the
    reference's per-code behaviour (framing.cc:702-744).  keep_traces
    keeps vals as the debug traces."""
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
        traces=vals if keep_traces else None,
    )


def search(window: torch.Tensor, cfg: ModemConfig, *, joint: bool,
           keep_traces: bool = False) -> MatchedFilterResult:
    """The (offset, sequence, rx) correlation search over the estimation
    region (starts one symbol before sync_index, framing.cc:284, 639-651)."""
    return finalize(corr_vals(window, cfg), cfg, joint=joint,
                    keep_traces=keep_traces)
