"""Linear MMSE detection (port of rub_mimo_tpu/detect/mmse.py).

    W = G^H (G G^H + sigma^2 I)^{-1}

with the rows rescaled by 1/(W G)_kk so hard decisions are unbiased.
"""

from __future__ import annotations

from typing import Tuple

import torch


def mmse_weights(G: torch.Tensor,
                 noise_var) -> Tuple[torch.Tensor, torch.Tensor]:
    """G [..., N, N] (rx x tx), noise_var a float or a float32 device
    scalar -> (W [..., N, N] complex64, gain [...] = 1)
    in the form detect.zf.equalize takes."""
    N = G.shape[-1]
    Gh = torch.conj(G.transpose(-1, -2))
    A = G @ Gh + noise_var * torch.eye(N, dtype=G.dtype, device=G.device)
    # W0 = G^H A^{-1} == solve(A^T, conj(G))^T; solve_ex: solve's values
    # without its error check, which reads the status back and drains a
    # CUDA stream
    W0 = torch.linalg.solve_ex(A.transpose(-1, -2),
                               torch.conj(G)).result.transpose(-1, -2)
    d = torch.einsum("...ij,...ji->...i", W0, G)
    W = W0 / d[..., :, None]
    gain = torch.ones(G.shape[:-2], dtype=torch.float32, device=G.device)
    # contiguous: the CUDA payload kernels take W as [..., N, N] rows
    return W.to(torch.complex64).contiguous(), gain
