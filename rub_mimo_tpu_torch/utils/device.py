"""The device an entry point of the port runs on."""

from __future__ import annotations

import torch


def on_device(device) -> torch.device:
    """``device`` as a torch.device; a CUDA request without CUDA raises,
    and on CUDA float32 matrix products are kept in full float32 (see
    pipeline.rx.make_decoder)."""
    device = torch.device(device)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(f"device {device} requested but CUDA is not "
                               "available")
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    return device
