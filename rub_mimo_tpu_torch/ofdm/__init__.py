"""OFDM tables, constellations and TX framing (port of rub_mimo_tpu.ofdm)."""
