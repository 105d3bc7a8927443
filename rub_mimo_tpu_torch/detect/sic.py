"""Ordered successive interference cancellation (MMSE V-BLAST).

Port of rub_mimo_tpu/detect/sic.py.  T times (T = tx streams):
  1. the MMSE filter of the still-active streams,
     A = G^H G + sigma^2 I over the active columns, [n_sc, T, T];
  2. per subcarrier the stream with the best post-detection SINR
     (min diag(A^-1), the V-BLAST ordering rule);
  3. its hard decision (the K4 kernel on CUDA), whose reconstructed
     contribution is subtracted from y; its column is deactivated.
The emitted per-stream values are the unbiased MMSE outputs at detection
time, so a later demap reproduces the in-loop decisions.  The inverses
are torch.linalg.inv_ex's: the same values as inv without its error
check, which reads the status back and drains a CUDA stream.  The ordering
argmin can flip between backends where two streams' errors are equal to
within rounding.
"""

from __future__ import annotations

import numpy as np
import torch

from rub_mimo_tpu_torch.config import ModemConfig
from rub_mimo_tpu_torch.ofdm import constellation


def sic_equalize(Y: torch.Tensor, G_occ: torch.Tensor, cfg: ModemConfig,
                 noise_var=1e-3) -> torch.Tensor:
    """Y: [n_sym, rx, n_sc], G_occ: [n_sc, rx, tx] ->
    eq [n_sym, tx, n_sc] (unbiased per-stream soft estimates)."""
    n_sc, _, T = G_occ.shape
    dev = Y.device
    table = constellation.table_on(cfg.modulation, dev)
    nv = float(np.float32(noise_var))
    y = Y.transpose(1, 2).to(torch.complex64)      # [n_sym, n_sc, rx]
    G = G_occ.to(torch.complex64)
    active = torch.ones((n_sc, T), dtype=torch.bool, device=dev)
    eq_out = torch.zeros((Y.shape[0], T, n_sc), dtype=torch.complex64,
                         device=dev)
    eyeT = torch.eye(T, dtype=torch.complex64, device=dev)

    for _ in range(T):
        Gm = G * active[:, None, :]
        Gh = torch.conj(Gm.transpose(-1, -2))
        A = Gh @ Gm + nv * eyeT
        inv = torch.linalg.inv_ex(A).inverse        # [n_sc, T, T]
        err = torch.diagonal(inv, dim1=-2, dim2=-1).real
        err = torch.where(active, err, 3e38)
        j = torch.argmin(err, dim=-1)               # [n_sc]
        onehot = torch.nn.functional.one_hot(j, T).to(torch.complex64)

        W0 = inv @ Gh                               # [n_sc, T, rx]
        w = torch.einsum("st,str->sr", onehot, W0)  # row j per sc
        g_j = torch.einsum("srt,st->sr", G, onehot)  # column j per sc
        d = torch.einsum("sr,sr->s", w, g_j)        # bias (W0 G)_jj
        w = w / d[:, None]

        s_hat = torch.einsum("sr,nsr->ns", w, y)    # [n_sym, n_sc]
        eq_out = eq_out + torch.einsum("ns,st->nts", s_hat, onehot)

        dec = constellation.demodulate(s_hat, cfg.modulation)
        s_dec = table[dec.long()]                   # [n_sym, n_sc]
        y = y - g_j[None] * s_dec[..., None]
        active = active & (onehot.real < 0.5)
    return eq_out.to(torch.complex64)
