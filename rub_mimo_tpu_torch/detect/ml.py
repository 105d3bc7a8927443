"""Joint maximum-likelihood MIMO detection by exhaustive search.

Port of rub_mimo_tpu/detect/ml.py (ml_detect, ml_equalize; the soft
ml_soft_llrs belongs with forward error correction).  Per subcarrier and
OFDM symbol

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


def ml_equalize(Y: torch.Tensor, G_occ: torch.Tensor, cfg: ModemConfig,
                block: int = 16) -> torch.Tensor:
    """ML decisions remodulated to constellation points,
    [n_sym, tx, n_sc] like the linear equalizers' output."""
    d = ml_detect(Y, G_occ, cfg, block=block)
    return constellation.table_on(cfg.modulation, Y.device)[d.long()]
