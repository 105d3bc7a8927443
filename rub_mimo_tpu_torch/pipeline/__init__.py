"""The RX decode pipeline and scoring (port of rub_mimo_tpu.pipeline)."""
