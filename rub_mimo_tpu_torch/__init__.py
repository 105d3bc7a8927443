"""rub_mimo_tpu_torch — the PyTorch / CUDA port of rub_mimo_tpu.

The JAX package (rub_mimo_tpu) stays the reference; this package grows
beside it, module for module, and is held against it by the parity tests
(tests/test_torch_*.py).  It imports torch and never jax: the only module
of the JAX package it uses is the stdlib-only ``rub_mimo_tpu.config``,
re-exported here so callers need nothing else.

Ported so far: the 2x2 RX_ZF decode main path (sync, matched filter, LS
estimate, ZF/MMSE weights, payload tail), the TX side and channel
simulator that build its captures, and the hand-written CUDA payload
kernel (kernels/csrc/payload_fused_strip.cu).
"""

from rub_mimo_tpu.config import (
    CommMode,
    Detector,
    ModemConfig,
    Modulation,
    tiny_config,
)

__all__ = ["CommMode", "Detector", "ModemConfig", "Modulation", "tiny_config"]
