"""Capture sources (port of rub_mimo_tpu.io): the channel simulator."""
