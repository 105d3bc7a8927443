"""Linear MIMO detection (port of rub_mimo_tpu.detect: ZF and MMSE)."""
