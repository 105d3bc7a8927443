"""Named system presets (port of rub_mimo_tpu.models)."""
