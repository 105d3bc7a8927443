"""Decision-directed channel tracking across the payload.

Port of rub_mimo_tpu/detect/tracking.py, its lax.scan a Python loop:
blocks of ``block_frames`` OFDM symbols are processed in order, each

  1. equalized with the carried Ghat (ZF),
  2. hard-decided (the K4 kernel on CUDA) and remodulated to s_hat,
  3. refit per subcarrier by LS: G_new = (sum_n y s^H)(sum_n s s^H + eI)^-1,
  4. blended: G <- (1 - alpha) G + alpha G_new.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from rub_mimo_tpu_torch.config import ModemConfig
from rub_mimo_tpu_torch.detect import zf
from rub_mimo_tpu_torch.ofdm import constellation


def ls_refit(Yblk: torch.Tensor, s_hat: torch.Tensor,
             ridge: float = 1e-3) -> torch.Tensor:
    """Per-subcarrier LS channel refit from decisions.  Yblk, s_hat:
    [B, S, n_sc]; returns G_new [n_sc, S, S]."""
    S = Yblk.shape[1]
    eye = torch.eye(S, dtype=torch.complex64, device=Yblk.device)
    A = torch.einsum("nts,nus->stu", s_hat, torch.conj(s_hat))
    B = torch.einsum("nrs,nus->sru", Yblk, torch.conj(s_hat))
    # inv_ex: inv's values without its error check, which reads the
    # status back and drains a CUDA stream once per block
    ridged = A + float(np.float32(ridge)) * eye
    return B @ torch.linalg.inv_ex(ridged).inverse


def track_and_equalize(Y: torch.Tensor, G0: torch.Tensor, cfg: ModemConfig,
                       *, block_frames: int = 16, alpha: float = 0.5,
                       ridge: float = 1e-3
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Y: [n_sym, S, n_sc]; G0: [n_sc, S, S] the preamble estimate.
    Returns (eq [n_sym, S, n_sc], G_last [n_sc, S, S]); n_sym must be a
    multiple of block_frames."""
    n_sym, S, n_sc = Y.shape
    if n_sym % block_frames:
        raise ValueError(f"track_and_equalize: {n_sym} symbols are not a "
                         f"multiple of block_frames={block_frames}")
    table = constellation.table_on(cfg.modulation, Y.device)
    G = G0.to(torch.complex64)
    eqs = []
    for b in range(n_sym // block_frames):
        Yblk = Y[b * block_frames:(b + 1) * block_frames]
        W, gain = zf.invert(G, cfg.invert_to_unity)
        eq = zf.equalize(Yblk, W, gain)             # [B, S, n_sc]
        d = constellation.demodulate(eq, cfg.modulation)
        G_new = ls_refit(Yblk, table[d.long()], ridge)
        G = ((1.0 - alpha) * G + alpha * G_new).to(torch.complex64)
        eqs.append(eq)
    return torch.cat(eqs, dim=0), G
