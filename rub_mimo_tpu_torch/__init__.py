"""rub_mimo_tpu_torch — the PyTorch / CUDA port of rub_mimo_tpu.

The JAX package (rub_mimo_tpu) stays the reference; this package grows
beside it, module for module, and is held against it by the parity tests
(tests/test_torch_*.py).  It imports torch and never jax, and nothing of
the JAX package: its configuration is its own copy (``config``), and
``convert.config_from_jax`` carries a JAX config over.

Ported so far: the decode (rx.decode / rx.make_decoder) with its
acquisition options (sync impls coarse / xla / pallas, the S0 fallback,
CFO correction, channel smoothing, the measured-noise MMSE, the debug
outputs) and its payload tails (guard bands, the SISO, RX_DIVERSITY,
ALAMOUTI and beamforming modes, the ZF, MMSE, SIC and ML detectors,
channel and phase tracking), the TX side and channel simulator that
build its captures, the presets (models.presets), the sharded decode and
batched serving over a device mesh (parallel), the serving decoder and
decode_all (pipeline.rx), the streaming decoder (pipeline.streaming,
with its SFO and front-end options), the coded chain and SFO correction,
the command line (apps.cli) with what it drives (capture files and the
native ingest, the RX front end, precoded TX, artifacts, checkpoints,
stage profiling), the sharded decode across processes
(parallel.mesh.init_distributed, parallel.multiprocess), the offline
analysis, HTML report and live view (apps), the device registry
(io.devices), and hand-written CUDA kernels (kernels/csrc/): the
strip-fused payload tail, the fused payload tail, the CP strip, equalize
+ demap, the hard demap, the one-pass sync, the S&C metric, the halo
exchange, the Viterbi decoder and the soft LLRs.
"""

from rub_mimo_tpu_torch.config import (
    CommMode,
    Detector,
    ModemConfig,
    Modulation,
    tiny_config,
)

__all__ = ["CommMode", "Detector", "ModemConfig", "Modulation", "tiny_config"]
