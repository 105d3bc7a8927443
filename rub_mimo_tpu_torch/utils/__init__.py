"""Array helpers (port of rub_mimo_tpu.utils)."""
