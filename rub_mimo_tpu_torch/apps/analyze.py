"""Offline analysis of experiment artifacts — the mimo/apps/plot.py
successor (port of rub_mimo_tpu/apps/analyze.py, on the port's
io.capture readers; it reads the artifacts either package's CLI writes).

Loads the binary artifact set a run dumps (pipeline.artifacts mirrors the
reference's /tmp layout, mimo/apps/plot.py:27-40) and computes/plots:

  - per-position symbol diffs and error histogram over carrier index
    (plot.py:44-66)
  - error ECDF (plot.py:54-72)
  - TX/RX time signals, S&C sync metric, per-access-code correlation
    traces, TX-vs-RX symbol overlay (plot.py:110-176)
  - constellation scatter + per-stream time plots — the 8 figures the Qt
    GUI's Figure grid was meant to show (Interface/mainwindow.cpp:24-31)

Python 3, parameterized by the capture's manifest/config instead of
plot.py's hardcoded num_occupied_carriers=818 (plot.py:12).  Matplotlib is
optional and imported by plot_run only: all statistics are computable
headless via analyze().
"""

from __future__ import annotations

import dataclasses
from pathlib import Path
from typing import Dict, Optional

import numpy as np

from rub_mimo_tpu_torch.config import ModemConfig
from rub_mimo_tpu_torch.io import capture as capio


@dataclasses.dataclass
class RunArtifacts:
    tx: Optional[np.ndarray] = None        # [S, T] raw TX IQ
    rx: Optional[np.ndarray] = None        # [S, T] raw RX IQ
    f_sc: Optional[np.ndarray] = None      # [S, T] sync metric
    tx_sig: Optional[np.ndarray] = None    # [S, N] tx symbols
    rx_sig: Optional[np.ndarray] = None    # [S, N] equalized rx symbols
    tx_data: Optional[np.ndarray] = None   # [S, N] tx symbol indices
    rx_data: Optional[np.ndarray] = None   # [S, N] rx symbol indices
    corr: Dict[tuple, np.ndarray] = dataclasses.field(default_factory=dict)


def load(directory: str | Path, num_streams: int = 2) -> RunArtifacts:
    d = Path(directory)
    art = RunArtifacts()

    def stack(fmt, reader):
        files = [d / fmt.format(s + 1) for s in range(num_streams)]
        if not all(f.exists() for f in files):
            return None
        arrs = [reader(f) for f in files]
        n = min(len(a) for a in arrs)
        return np.stack([a[:n] for a in arrs])

    art.tx = stack("tx{}.dat", capio.read_iq)
    art.rx = stack("rx{}.dat", capio.read_iq)
    art.f_sc = stack("f_sc_{}.dat", capio.read_metric)
    art.tx_sig = stack("tx_sig{}.dat", capio.read_iq)
    art.rx_sig = stack("rx_sig{}.dat", capio.read_iq)
    art.tx_data = stack("tx_data{}.dat", capio.read_data)
    art.rx_data = stack("rx_data{}.dat", capio.read_data)
    for f in sorted(d.glob("corr_*_*.dat")):
        chan, ac = f.stem.split("_")[1:3]
        art.corr[(int(chan), int(ac))] = capio.read_metric(f)
    return art


def analyze(art: RunArtifacts, m_occupied: int) -> Dict:
    """Error statistics per plot.py:44-72, parameterized by M_occupied."""
    out: Dict = {}
    if art.tx_data is None or art.rx_data is None:
        return out
    S, N = art.rx_data.shape
    n = min(N, art.tx_data.shape[1])
    diff = (art.rx_data[:, :n] != art.tx_data[:, :n]).astype(np.int64)
    out["diff"] = diff
    out["errors_total"] = diff.sum(axis=1)
    out["ser"] = diff.mean(axis=1)
    # error histogram over carrier index (plot.py:58-61)
    carrier = np.arange(n) % m_occupied
    out["error_by_carrier"] = np.stack(
        [np.bincount(carrier, weights=diff[s], minlength=m_occupied)
         for s in range(S)]
    )
    # error ECDF (plot.py:54-72)
    csum = diff.cumsum(axis=1).astype(np.float64)
    totals = np.maximum(csum[:, -1:], 1.0)
    out["ecdf"] = csum / totals
    return out


def plot_run(
    directory: str | Path,
    cfg: ModemConfig,
    out_path: Optional[str | Path] = None,
    show: bool = False,
):
    """Render the reference's figure set into one multi-panel figure."""
    import matplotlib

    if not show:
        matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    art = load(directory, cfg.num_streams)
    stats = analyze(art, cfg.M_occupied)
    S = cfg.num_streams

    fig, axes = plt.subplots(4, max(S, 2), figsize=(12, 14))
    for s in range(S):
        ax = axes[0][s]
        if art.rx is not None:
            ax.plot(np.abs(art.rx[s]), lw=0.3)
        ax.set_title(f"|rx{s + 1}| time signal")

        ax = axes[1][s]
        if art.f_sc is not None:
            ax.plot(art.f_sc[s], lw=0.3)
            ax.axhline(cfg.plateau_threshold, color="r", ls="--", lw=0.5)
        ax.set_title(f"S&C metric stream {s + 1}")

        ax = axes[2][s]
        if art.rx_sig is not None:
            pts = art.rx_sig[s][: 4096]
            ax.scatter(pts.real, pts.imag, s=1, alpha=0.4)
        ax.set_title(f"rx constellation stream {s + 1}")
        ax.set_aspect("equal")

        ax = axes[3][s]
        if "error_by_carrier" in stats:
            ax.plot(stats["error_by_carrier"][s], lw=0.5)
        ax.set_title(f"errors by carrier stream {s + 1}")
    fig.tight_layout()
    if out_path is not None:
        fig.savefig(out_path, dpi=120)
    if show:
        plt.show()
    return fig


def main(argv=None):
    import argparse

    ap = argparse.ArgumentParser(description="analyze a decode run")
    ap.add_argument("directory", type=Path)
    ap.add_argument("--config", type=Path, default=None)
    ap.add_argument("-o", "--out", type=Path, default=None)
    ap.add_argument("--show", action="store_true")
    args = ap.parse_args(argv)
    if args.config:
        cfg = ModemConfig.from_json(args.config.read_text())
    else:
        manifest = args.directory / "manifest.json"
        if manifest.exists():
            cfg = capio.CaptureManifest.load(manifest).config
        else:
            cfg = ModemConfig()
    art = load(args.directory, cfg.num_streams)
    stats = analyze(art, cfg.M_occupied)
    if "ser" in stats:
        for s, v in enumerate(stats["ser"]):
            print(f"stream {s}: SER {v * 100:.4f}%  "
                  f"({int(stats['errors_total'][s])} errors)")
    if args.out or args.show:
        plot_run(args.directory, cfg, out_path=args.out, show=args.show)
    return 0


if __name__ == "__main__":
    main()
