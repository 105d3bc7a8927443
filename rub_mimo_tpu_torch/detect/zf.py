"""Zero-forcing (channel-inversion) detection, batched per subcarrier.

Port of rub_mimo_tpu/detect/zf.py: the reference's hardcoded 2x2 invert()
(mimo/framing.cc:1344-1367) replicated exactly, plus an N x N path
(det * inverse as the adjugate).  With INVERT_TO_UNITY=false:

    det  = G00 G11 - G01 G10,   W = conj(det) * adj(G),   gain = 1/|det|^2

so W @ y * gain == inv(G) @ y (framing.cc:570-585).
"""

from __future__ import annotations

from typing import Tuple

import torch


def invert(G: torch.Tensor,
           invert_to_unity: bool = False) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-subcarrier equalizer from G [..., N, N]: (W [..., N, N]
    complex64, normalize_gain [...] float32)."""
    N = G.shape[-1]
    if N == 2:
        g00, g01 = G[..., 0, 0], G[..., 0, 1]
        g10, g11 = G[..., 1, 0], G[..., 1, 1]
        det = g00 * g11 - g01 * g10
        det_inv = 1.0 / det if invert_to_unity else torch.conj(det)
        W = torch.stack(
            [
                torch.stack([det_inv * g11, -det_inv * g01], dim=-1),
                torch.stack([-det_inv * g10, det_inv * g00], dim=-1),
            ],
            dim=-2,
        )
    else:
        det = torch.linalg.det(G)
        adj = torch.linalg.inv(G) * det[..., None, None]
        det_inv = (1.0 / det if invert_to_unity else torch.conj(det))
        W = det_inv[..., None, None] * adj
    if invert_to_unity:
        gain = torch.ones(G.shape[:-2], dtype=torch.float32, device=G.device)
    else:
        gain = 1.0 / (det.real ** 2 + det.imag ** 2)
    return W.to(torch.complex64), gain.to(torch.float32)


def equalize(Y: torch.Tensor, W: torch.Tensor,
             gain: torch.Tensor) -> torch.Tensor:
    """x[..., out, sc] = gain[sc] * sum_j W[sc, out, j] Y[..., j, sc].

    Y: [..., n_streams, n_sc]; W: [n_sc, n_out, n_streams]; gain: [n_sc].
    The sum over j runs in order j = 0, 1, ... (the JAX package's
    contraction order)."""
    S = W.shape[-1]
    Wt = W.permute(1, 2, 0)  # [n_out, n_streams, n_sc]
    eq = Wt[:, 0, :] * Y[..., 0, None, :]
    for j in range(1, S):
        eq = eq + Wt[:, j, :] * Y[..., j, None, :]
    return (eq * gain).to(torch.complex64)
