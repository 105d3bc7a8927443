"""A kernel's share of its roofline.

The least time the card could take for a call is the larger of the
bytes it must move over the memory rate and the float32 operations it
must do over the peak rate (``rooflines/peaks.json``): each input read
once and each output written once, whatever the kernel reads again.
Each ``rooflines/<kernel>.py`` gives ``KERNELS`` (the device kernels'
names in the trace) and ``per_capture(ctx)`` or ``bound(...)``: the
bytes and operations one capture needs.
"""

from __future__ import annotations


def least_seconds(n_bytes: float, flops: float, peaks: dict) -> float:
    return max(n_bytes / peaks["hbm_bytes_per_s"],
               flops / peaks["fp32_flops_per_s"])


def share(ctx, kernel: str):
    """100 x (the traced captures' least time) / (the kernel's device
    time in the trace), or None where the trace has no launch of it."""
    mod = ctx.registry.roofline(kernel)
    spent = ctx.trace.kernel_seconds(mod.KERNELS)
    if not spent:
        return None
    peaks = ctx.registry.peaks()
    need = sum(least_seconds(*mod.per_capture(ctx, i), peaks)
               for i in ctx.trace.pool_indices)
    return 100.0 * need / spent
