"""Window gathers at device offsets (port of rub_mimo_tpu/utils/gather.py).

The JAX package has two forms of the same gather, an element-level
gather and a scan of dynamic slices (the faster one on a TPU); on the
card one advanced-indexing gather does the job, and no offset is read
back to the host.

Besides, the capture window with the windowcf's read-zeros semantics
(framing.cc:284, 639-651): ``window_index`` places it, ``gather_window``
reads it.  The decode's payload and region slices and the plain version
of K1's windowed read (kernels/payload_fused.py) share it.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from rub_mimo_tpu_torch.utils.device_cache import device_constant


def gather_windows(arr: torch.Tensor, rows: torch.Tensor,
                   starts: torch.Tensor, length: int) -> torch.Tensor:
    """Stacked ``arr[rows[i], starts[i] : starts[i] + length]``: [n, length]
    from arr [R, W], rows and starts [n] integer tensors.  Each start is
    clamped to [0, W - length], as a JAX dynamic slice clamps it."""
    starts = torch.clamp(starts, 0, arr.shape[-1] - length)
    idx = starts.unsqueeze(1) + torch.arange(length, device=arr.device)
    return arr[rows.unsqueeze(1), idx]


class Window(NamedTuple):
    """The window [start, start + length) of a T-sample capture, read as
    zeros outside [0, T).  ``start`` is a device int64 scalar, never read
    on the host."""
    start: torch.Tensor
    length: int
    T: int


@device_constant
def _arange_on(n: int, device: torch.device) -> torch.Tensor:
    """[n] int32 0, 1, ..., n - 1 on ``device``, made once."""
    return torch.arange(n, dtype=torch.int32, device=device)


def start_on(start, device: torch.device) -> torch.Tensor:
    """A window start as a device int64 scalar; a Python int is filled in
    on the device (no host-to-device copy)."""
    if isinstance(start, torch.Tensor):
        return start.to(device=device, dtype=torch.int64)
    return torch.full((), int(start), dtype=torch.int64, device=device)


def window_index(start, length: int, T: int, device: torch.device) -> Window:
    """The window of ``length`` samples from ``start`` (a device scalar or
    a Python int; it may be negative or past the end) of a T-sample
    capture on ``device``.  Nothing is read back."""
    return Window(start_on(start, device), length, T)


def gather_window(iq: torch.Tensor, win: Window,
                  out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """iq's window [S, win.length] of iq [S, win.T], zeros at the
    positions outside the capture, into ``out`` when given.  One index
    serves every stream."""
    idx = win.start + _arange_on(win.length, iq.device)  # int32
    src = torch.clamp(idx, 0, max(win.T - 1, 0))
    out = torch.index_select(iq, 1, src, out=out)
    return out.masked_fill_(src != idx, 0)
