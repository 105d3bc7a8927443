"""Numerically robust moving sums (streaming FIR replacement).

Port of rub_mimo_tpu/utils/movsum.py.  The reference's Schmidl&Cox
detector runs constant-tap liquid-dsp FIRs one sample at a time
(framing.cc:626-637); over a whole capture that is a causal moving sum,
computed as a cumsum difference.  A single float32 cumsum over millions
of samples loses precision, so the sum is taken per overlapping chunk
(overlap-save, same chunking as the JAX package): error scales with the
block, not the capture.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def moving_sum(x: torch.Tensor, window: int, *,
               block: int = 1 << 15) -> torch.Tensor:
    """Causal moving sum along the last axis, out[t] = sum_{k<w} x[t-k],
    zeros before t=0 (a length-w constant-tap FIR from zero state).
    Real or complex; any leading dimensions."""
    T = x.shape[-1]
    w = int(window)
    B = max(int(block), w)
    nb = -(-T // B)
    # w samples of zero history on the left, whole blocks on the right;
    # chunk i covers padded[i*B : i*B + B + w]
    xp = F.pad(x, (w, nb * B - T))
    cs = torch.cumsum(xp.unfold(-1, B + w, B), dim=-1)
    out = cs[..., w: w + B] - cs[..., :B]
    return out.reshape(*x.shape[:-1], nb * B)[..., :T]


def delay(x: torch.Tensor, n: int) -> torch.Tensor:
    """Delay by n samples along the last axis with zero fill (liquid
    wdelaycf, framing.cc:629-630): out[t] = x[t-n], zeros for t < n."""
    if n == 0:
        return x
    return F.pad(x, (n, 0))[..., : x.shape[-1]]
