"""Applications of the port (port of rub_mimo_tpu.apps): the command
line (``python -m rub_mimo_tpu_torch.apps.cli``), the offline analysis
(``analyze``), the HTML report (``report_html``) and the live view of
the streaming decoder (``live_view``)."""

from rub_mimo_tpu_torch.apps import analyze, cli

__all__ = ["analyze", "cli"]
