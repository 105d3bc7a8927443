"""Applications of the port (port of rub_mimo_tpu.apps): the command
line, ``python -m rub_mimo_tpu_torch.apps.cli``."""
