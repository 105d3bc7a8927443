"""Self-contained HTML run report — the GUI-successor artifact (port of
rub_mimo_tpu/apps/report_html.py; matplotlib is imported by ``render``
only).

The reference's Qt Interface was meant to show 8 live figures
(constellations + time plots per stream, Interface/mainwindow.cpp:24-31)
but its Run button is a stub.  This module renders the same views from a
decode run's artifacts into ONE standalone HTML file (figures embedded as
base64 PNGs + the structured JSON report), viewable anywhere.
"""

from __future__ import annotations

import base64
import html
import io
from pathlib import Path
from typing import Optional

import numpy as np

from rub_mimo_tpu_torch.apps import analyze
from rub_mimo_tpu_torch.config import ModemConfig


def _fig_to_b64(fig) -> str:
    buf = io.BytesIO()
    fig.savefig(buf, format="png", dpi=110, bbox_inches="tight")
    return base64.b64encode(buf.getvalue()).decode()


def render(
    directory: str | Path,
    cfg: ModemConfig,
    out_path: str | Path,
    report_json: Optional[str] = None,
    title: str = "rub-mimo-tpu run report",
) -> Path:
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    art = analyze.load(directory, cfg.num_streams)
    stats = analyze.analyze(art, cfg.M_occupied)
    S = cfg.num_streams

    sections = []

    def add_fig(name, plot_fn):
        fig, ax = plt.subplots(figsize=(7, 3.2))
        plot_fn(ax)
        sections.append(
            f"<h3>{html.escape(name)}</h3>"
            f'<img src="data:image/png;base64,{_fig_to_b64(fig)}"/>'
        )
        plt.close(fig)

    for s in range(S):
        if art.rx is not None:
            add_fig(
                f"|rx{s + 1}| time signal",
                lambda ax, s=s: ax.plot(np.abs(art.rx[s]), lw=0.3),
            )
        if art.f_sc is not None:
            def sync_plot(ax, s=s):
                ax.plot(art.f_sc[s], lw=0.3)
                ax.axhline(cfg.plateau_threshold, color="r", ls="--", lw=0.6)
            add_fig(f"S&C sync metric, stream {s + 1}", sync_plot)
        if art.rx_sig is not None:
            def const_plot(ax, s=s):
                pts = art.rx_sig[s][:8192]
                ax.scatter(pts.real, pts.imag, s=1.5, alpha=0.35)
                ax.set_aspect("equal")
            add_fig(f"RX constellation, stream {s + 1}", const_plot)
        if "error_by_carrier" in stats:
            add_fig(
                f"errors by carrier, stream {s + 1}",
                lambda ax, s=s: ax.plot(stats["error_by_carrier"][s], lw=0.5),
            )

    stats_rows = ""
    if "ser" in stats:
        for s in range(S):
            stats_rows += (
                f"<tr><td>stream {s}</td>"
                f"<td>{stats['ser'][s] * 100:.4f}%</td>"
                f"<td>{int(stats['errors_total'][s])}</td></tr>"
            )
    report_block = (
        f"<h3>report</h3><pre>{html.escape(report_json)}</pre>"
        if report_json
        else ""
    )
    doc = f"""<!DOCTYPE html>
<html><head><meta charset="utf-8"><title>{html.escape(title)}</title>
<style>body{{font-family:system-ui,sans-serif;max-width:900px;margin:2em auto}}
img{{max-width:100%}}table{{border-collapse:collapse}}
td,th{{border:1px solid #999;padding:4px 10px}}</style></head><body>
<h1>{html.escape(title)}</h1>
<p>config: M={cfg.M}, CP={cfg.cp_len}, streams={cfg.num_streams},
codes={cfg.num_access_codes}, frames={cfg.pid_max},
modulation={cfg.modulation.value}, detector={cfg.detector.value},
mode={cfg.mode.value}</p>
<table><tr><th>stream</th><th>SER</th><th>errors</th></tr>{stats_rows}</table>
{report_block}
{''.join(sections)}
</body></html>"""
    out_path = Path(out_path)
    out_path.write_text(doc)
    return out_path
