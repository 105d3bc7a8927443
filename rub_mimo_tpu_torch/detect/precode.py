"""TX precoding (closed-loop beamforming).

Port of rub_mimo_tpu/detect/precode.py.  The reference sketches CSI
feedback -> a precoder -> precoded transmission on its dead
TX_BEAMFORMING path (mimo/main.cc:98-102, 381-790); here the loop is
real: decode a first exchange for Ghat, design a per-subcarrier ZF or
MMSE precoder from it, and transmit with the precoder on the access codes
and the payload (ofdm.framegen.transmit_frame(precoder=)).  The receiver
then estimates the effective channel G @ P ~ I, and its ordinary ZF
detection recovers the streams.

Precoders are normalized so each subcarrier's average TX power per
stream matches the unprecoded frame.  The inverses use inv_ex / solve_ex
(no error-check read back to the host).
"""

from __future__ import annotations

import torch


def _normalize(P: torch.Tensor) -> torch.Tensor:
    """Scale each subcarrier's precoder to ||P[sc]||_F^2 == n_streams."""
    n = P.shape[-1]
    fro2 = torch.sum(P.real ** 2 + P.imag ** 2, dim=(-2, -1))
    scale = torch.sqrt(n / torch.clamp(fro2, min=1e-20))
    return (P * scale[..., None, None]).to(torch.complex64)


def zf_precoder(G_occ: torch.Tensor) -> torch.Tensor:
    """Channel inversion, P = G^{-1} normalized: G_occ [n_sc, rx, tx] ->
    P [n_sc, tx_antenna, stream]."""
    return _normalize(torch.linalg.inv_ex(G_occ).inverse)


def mmse_precoder(G_occ: torch.Tensor, noise_var: float) -> torch.Tensor:
    """The regularized (Wiener) precoder P = G^H (G G^H + n I)^{-1},
    normalized."""
    n = G_occ.shape[-1]
    Gh = torch.conj(G_occ.transpose(-1, -2))
    A = G_occ @ Gh + noise_var * torch.eye(n, dtype=G_occ.dtype,
                                           device=G_occ.device)
    P = torch.linalg.solve_ex(A.transpose(-1, -2),
                              torch.conj(G_occ)).result.transpose(-1, -2)
    return _normalize(P)


def effective_channel(G_occ: torch.Tensor, P: torch.Tensor) -> torch.Tensor:
    """What the receiver sees after precoding: G @ P per subcarrier."""
    return (G_occ @ P).to(torch.complex64)
