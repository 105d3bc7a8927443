"""Window gathers at device offsets (port of rub_mimo_tpu/utils/gather.py).

The JAX package has two forms of the same gather, an element-level
gather and a scan of dynamic slices (the faster one on a TPU); on the
card one advanced-indexing gather does the job, and no offset is read
back to the host.
"""

from __future__ import annotations

import torch


def gather_windows(arr: torch.Tensor, rows: torch.Tensor,
                   starts: torch.Tensor, length: int) -> torch.Tensor:
    """Stacked ``arr[rows[i], starts[i] : starts[i] + length]``: [n, length]
    from arr [R, W], rows and starts [n] integer tensors.  Each start is
    clamped to [0, W - length], as a JAX dynamic slice clamps it."""
    starts = torch.clamp(starts, 0, arr.shape[-1] - length)
    idx = starts.unsqueeze(1) + torch.arange(length, device=arr.device)
    return arr[rows.unsqueeze(1), idx]
