"""rub_mimo_tpu_torch — the PyTorch / CUDA port of rub_mimo_tpu.

The JAX package (rub_mimo_tpu) stays the reference; this package grows
beside it, module for module, and is held against it by the parity tests
(tests/test_torch_*.py).  It imports torch and never jax: the only module
of the JAX package it uses is the stdlib-only ``rub_mimo_tpu.config``,
re-exported here so callers need nothing else.

Ported so far: the 2x2 RX_ZF decode with its acquisition options
(sync impls coarse / xla / pallas, the S0 fallback, CFO correction,
channel smoothing, the measured-noise MMSE, the debug outputs), the TX
side and channel simulator that build its captures, and three
hand-written CUDA kernels (kernels/csrc/): the payload tail, the
one-pass sync and the S&C metric.
"""

from rub_mimo_tpu.config import (
    CommMode,
    Detector,
    ModemConfig,
    Modulation,
    tiny_config,
)

__all__ = ["CommMode", "Detector", "ModemConfig", "Modulation", "tiny_config"]
