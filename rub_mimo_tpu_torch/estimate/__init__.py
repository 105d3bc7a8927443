"""Channel estimation (port of rub_mimo_tpu.estimate)."""
