"""Joint maximum-likelihood MIMO detection by exhaustive search.

Port of rub_mimo_tpu/detect/ml.py (ml_detect, ml_equalize and the soft
output ml_soft_llrs that ofdm/fec.decode_payload_ml decodes).  Per
subcarrier and OFDM symbol

    s_hat = argmin_{s in A^T} |y - G s|^2
          = argmin_s |G s|^2 - 2 Re(y^H G s)

over all arity^T candidate vectors: |Gs|^2 is precomputed per
subcarrier, the cross term is one batched complex product.  Symbols go in
blocks of 16 so the [block, n_sc, candidates] score tensor stays bounded
(134 MB a block for 2x2 32-ary at M = 2048; 8.4 GB for the whole
payload at once).
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from rub_mimo_tpu_torch.config import ModemConfig, Modulation
from rub_mimo_tpu_torch.ofdm import constellation
from rub_mimo_tpu_torch.utils.device_cache import device_constant


@functools.lru_cache(maxsize=None)
def combo_table(modulation: Modulation, n_tx: int):
    """(points [C, n_tx] complex64, indices [C, n_tx] int32), numpy, for
    all arity^n_tx candidate tx vectors (the last stream fastest)."""
    t = constellation.table(modulation)
    grids = np.meshgrid(*([np.arange(len(t))] * n_tx), indexing="ij")
    idx = np.stack([g.reshape(-1) for g in grids], axis=-1)
    return t[idx].astype(np.complex64), idx.astype(np.int32)


@device_constant
def _combos_on(modulation: Modulation, n_tx: int, device: torch.device):
    """``combo_table`` on ``device``, made once per device."""
    pts, idx = combo_table(modulation, n_tx)
    return (torch.as_tensor(pts, device=device),
            torch.as_tensor(idx, device=device))


def ml_detect(Y: torch.Tensor, G_occ: torch.Tensor, cfg: ModemConfig,
              block: int = 16) -> torch.Tensor:
    """Y: [n_sym, rx, n_sc]; G_occ: [n_sc, rx, tx] -> per-stream symbol
    decisions [n_sym, tx, n_sc] int32."""
    n_sym = Y.shape[0]
    n_tx = G_occ.shape[-1]
    pts, idx = _combos_on(cfg.modulation, n_tx, Y.device)
    GS = torch.einsum("krt,ct->krc", G_occ, pts)     # [n_sc, rx, C]
    e = torch.sum(GS.abs() ** 2, dim=1)              # [n_sc, C]
    out = []
    for b0 in range(0, n_sym, block):
        yb = Y[b0:b0 + block]                        # [b, rx, n_sc]
        dot = torch.einsum("nrk,krc->nkc", torch.conj(yb), GS).real
        best = torch.argmin(e[None] - 2.0 * dot, dim=-1)  # [b, n_sc]
        out.append(idx[best])                        # [b, n_sc, tx]
    return torch.cat(out).transpose(1, 2).to(torch.int32).contiguous()


def ml_soft_llrs(Y: torch.Tensor, G_occ: torch.Tensor, cfg: ModemConfig,
                 noise_var: float | torch.Tensor = 1.0,
                 block: int = 16) -> torch.Tensor:
    """Max-log-MAP bit LLRs of the joint lattice search (soft-output ML):
    llr_j = (min over candidates with bit j = 1 of |y - Gc|^2 - min over
    those with bit j = 0) / noise_var, so the inter-stream interference is
    marginalized in the lattice.  Positive -> bit 0, bits MSB-first per
    symbol and stream.  Y: [n_sym, rx, n_sc] -> [n_sym, tx, n_sc, bps].

    The candidate index is the tx streams' bits MSB-first (the last
    stream fastest), so bit j splits it as [2^j, 2, 2^(nbits-1-j)] and
    each masked minimum is a reduction over a view."""
    n_sym, _, n_sc = Y.shape
    n_tx = G_occ.shape[-1]
    bps = cfg.modulation.bits_per_symbol
    nbits = n_tx * bps
    pts, _ = _combos_on(cfg.modulation, n_tx, Y.device)
    GS = torch.einsum("krt,ct->krc", G_occ, pts)     # [n_sc, rx, C]
    e = torch.sum(GS.abs() ** 2, dim=1)              # [n_sc, C]
    out = []
    for b0 in range(0, n_sym, block):
        yb = Y[b0:b0 + block]                        # [b, rx, n_sc]
        d2 = (torch.sum(yb.abs() ** 2, dim=1)[:, :, None]
              - 2.0 * torch.einsum("nrk,krc->nkc", torch.conj(yb), GS).real
              + e[None])                             # [b, n_sc, C]
        nb = d2.shape[0]
        llr = torch.empty((nb, n_sc, nbits), dtype=torch.float32,
                          device=Y.device)
        for j in range(nbits):
            v = d2.view(nb, n_sc, 1 << j, 2, 1 << (nbits - 1 - j))
            llr[..., j] = (v[:, :, :, 1].amin(dim=(2, 3))
                           - v[:, :, :, 0].amin(dim=(2, 3)))
        out.append(llr)
    llrs = torch.cat(out).reshape(n_sym, n_sc, n_tx, bps).transpose(1, 2)
    return llrs / constellation._f32(noise_var)


def ml_equalize(Y: torch.Tensor, G_occ: torch.Tensor, cfg: ModemConfig,
                block: int = 16) -> torch.Tensor:
    """ML decisions remodulated to constellation points,
    [n_sym, tx, n_sc] like the linear equalizers' output."""
    d = ml_detect(Y, G_occ, cfg, block=block)
    return constellation.table_on(cfg.modulation, Y.device)[d.long()]
