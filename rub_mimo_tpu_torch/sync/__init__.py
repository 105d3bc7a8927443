"""Frame synchronization and timing (port of rub_mimo_tpu.sync)."""
