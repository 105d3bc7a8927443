"""Live constellation / time-series view for the streaming decoder (port
of rub_mimo_tpu/apps/live_view.py: the same page and JSON snapshot).

Closes the reference GUI's intended function (Interface/mainwindow.ui:
four constellation + four time plots updating as the run progresses,
figure.cpp:4-28, mainwindow.cpp:24-31 — whose Run button was never
wired, mainwindow.cpp:332-337): a zero-dependency HTTP server renders an
auto-refreshing page whose plots are drawn client-side (canvas) from a
JSON snapshot the decoder updates as frames arrive.

Usage (library):

    view = LiveView(cfg, port=8000)
    view.start()
    dec = StreamingDecoder(cfg, device=device, chunk_size=chunk)
    for chunk in source:
        view.add_frames(dec.push(chunk))   # frames stay on the device
        view.set_status(phase=dec.phase, synced=dec.synced)
    view.stop()

CLI (replays a capture through the streaming decoder, on CUDA, or on the
CPU with --cpu; --once exits after the replay instead of serving the
final state):

    python -m rub_mimo_tpu_torch.apps.live_view <capture_dir> [--port 8000]
"""

from __future__ import annotations

import json
import sys
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Iterable, Optional, Tuple

import numpy as np
import torch

from rub_mimo_tpu_torch.config import ModemConfig

_PAGE = """<!DOCTYPE html>
<html><head><title>rub-mimo-tpu live</title><style>
body { font-family: sans-serif; background: #111; color: #ddd; }
canvas { background: #181818; border: 1px solid #333; margin: 4px; }
h1 { font-size: 16px; } .row { white-space: nowrap; }
#status { color: #8c8; font-family: monospace; }
</style></head><body>
<h1>rub-mimo-tpu live decoder</h1>
<div id="status">waiting for data...</div>
<div class="row" id="consts"></div>
<div class="row" id="times"></div>
<script>
function draw(d) {
  document.getElementById("status").textContent =
    `phase=${d.phase} synced=${d.synced} frames=${d.n_frames}` +
    (d.sync_index !== null ? ` sync_index=${d.sync_index}` : "") +
    (d.cfo_hat !== null ? ` cfo=${Number(d.cfo_hat).toFixed(5)}` : "");
  const S = d.constellations.length;
  const cdiv = document.getElementById("consts");
  const tdiv = document.getElementById("times");
  while (cdiv.children.length < S) {
    for (const div of [cdiv, tdiv]) {
      const c = document.createElement("canvas");
      c.width = 280; c.height = 280; div.appendChild(c);
    }
  }
  for (let s = 0; s < S; s++) {
    const c = cdiv.children[s], g = c.getContext("2d");
    g.clearRect(0, 0, c.width, c.height);
    g.fillStyle = "#6cf";
    const pts = d.constellations[s];
    const lim = d.lim || 2;
    for (let i = 0; i < pts.length; i += 2) {
      const x = (pts[i] / lim + 1) * c.width / 2;
      const y = (1 - pts[i+1] / lim) * c.height / 2;
      g.fillRect(x, y, 2, 2);
    }
    g.fillStyle = "#888";
    g.fillText(`stream ${s} constellation`, 6, 12);
    const t = tdiv.children[s], h = t.getContext("2d");
    h.clearRect(0, 0, t.width, t.height);
    const tr = d.time[s];
    h.strokeStyle = "#fc6"; h.beginPath();
    for (let i = 0; i < tr.length; i += 2) {
      const x = (i / 2) / (tr.length / 2) * t.width;
      const y = (1 - tr[i] / lim) * t.height / 2;
      if (i === 0) h.moveTo(x, y); else h.lineTo(x, y);
    }
    h.stroke();
    h.strokeStyle = "#6f6"; h.beginPath();
    for (let i = 1; i < tr.length; i += 2) {
      const x = ((i-1) / 2) / (tr.length / 2) * t.width;
      const y = (1 - tr[i] / lim) * t.height / 2;
      if (i === 1) h.moveTo(x, y); else h.lineTo(x, y);
    }
    h.stroke();
    h.fillStyle = "#888";
    h.fillText(`stream ${s} re/im (latest frame)`, 6, 12);
  }
}
async function tick() {
  try {
    const r = await fetch("/data.json");
    if (r.ok) draw(await r.json());
  } catch (e) {}
  setTimeout(tick, 500);
}
tick();
</script></body></html>
"""


class LiveView:
    """Holds the latest decoder snapshot and serves it over HTTP."""

    def __init__(self, cfg: ModemConfig, port: int = 8000,
                 max_points: int = 4000):
        self.cfg = cfg
        self.port = port
        self.max_points = max_points
        self._lock = threading.Lock()
        self._const = [np.zeros((0,), np.complex64)
                       for _ in range(cfg.num_streams)]
        self._latest: Optional[np.ndarray] = None  # [S, m_occ]
        self._status = {"phase": "seek", "synced": False,
                        "sync_index": None, "cfo_hat": None}
        self._n_frames = 0
        self._srv: Optional[ThreadingHTTPServer] = None
        self._thread: Optional[threading.Thread] = None

    # ---- decoder-side API ----
    def add_frames(self, frames: Iterable[Tuple[int, object]]) -> None:
        """Take a push's (frame index, [S, M_occupied]) frames: numpy
        arrays, or tensors on any device, which come to the host in one
        copy a call."""
        frames = [f for _, f in frames]
        if frames and all(isinstance(f, torch.Tensor) for f in frames):
            frames = list(torch.stack(frames).cpu().numpy())
        with self._lock:
            for frame in frames:
                f = np.asarray(frame)
                self._latest = f
                self._n_frames += 1
                for s in range(self.cfg.num_streams):
                    cat = np.concatenate([self._const[s], f[s]])
                    self._const[s] = cat[-self.max_points:]

    def set_status(self, **kv) -> None:
        with self._lock:
            self._status.update(kv)

    def snapshot_json(self) -> bytes:
        with self._lock:
            lim = 1.0
            consts = []
            for c in self._const:
                if c.size:
                    lim = max(lim, float(np.abs(c).max()))
                consts.append(
                    np.stack([c.real, c.imag], -1).reshape(-1)
                    .astype(np.float32).round(4).tolist()
                )
            times = []
            for s in range(self.cfg.num_streams):
                if self._latest is not None:
                    t = self._latest[s][:512]
                    times.append(
                        np.stack([t.real, t.imag], -1).reshape(-1)
                        .astype(np.float32).round(4).tolist()
                    )
                else:
                    times.append([])
            d = dict(self._status)
            d.update({"constellations": consts, "time": times,
                      "n_frames": self._n_frames, "lim": round(lim, 3)})
        return json.dumps(d).encode()

    # ---- server ----
    def start(self) -> int:
        view = self

        class Handler(BaseHTTPRequestHandler):
            def do_GET(self):  # noqa: N802 (stdlib API)
                if self.path in ("/", "/index.html"):
                    body = _PAGE.encode()
                    ctype = "text/html"
                elif self.path == "/data.json":
                    body = view.snapshot_json()
                    ctype = "application/json"
                else:
                    self.send_response(404)
                    self.end_headers()
                    return
                self.send_response(200)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def log_message(self, *a):  # quiet
                pass

        self._srv = ThreadingHTTPServer(("127.0.0.1", self.port), Handler)
        self.port = self._srv.server_address[1]  # resolves port=0
        self._thread = threading.Thread(
            target=self._srv.serve_forever, daemon=True
        )
        self._thread.start()
        return self.port

    def stop(self) -> None:
        if self._srv is not None:
            self._srv.shutdown()
            self._srv.server_close()
            self._srv = None


def replay(view: LiveView, capture, cfg: ModemConfig, *, device,
           chunk_size: int = 1 << 16, rate: float = 0.0):
    """Replay a [S, T] capture (moved to ``device`` once, the last chunk
    zero-padded) through a StreamingDecoder into ``view``, at ``rate``
    samples/s over all streams (0: as fast as possible).  Returns the
    decoder (finalized) and the frames the view took, {k: [S, M_occ]
    tensor}."""
    from rub_mimo_tpu_torch.pipeline import streaming

    dec = streaming.StreamingDecoder(cfg, device=device,
                                     chunk_size=chunk_size)
    x = dec._to_device(capture)
    nc = -(-x.shape[-1] // chunk_size)
    x = torch.nn.functional.pad(x, (0, nc * chunk_size - x.shape[-1]))
    shown = {}

    def show(frames):
        view.add_frames(frames)
        shown.update(frames)

    for i in range(nc):
        t0 = time.perf_counter()
        show(dec.push(x[:, i * chunk_size:(i + 1) * chunk_size]))
        view.set_status(
            phase=dec.phase, synced=bool(dec.synced),
            sync_index=dec.sync_index,
            cfo_hat=float(dec.cfo_hat) if dec.cfo_hat else None)
        if rate > 0:
            budget = chunk_size * cfg.num_streams / rate
            dt = time.perf_counter() - t0
            if dt < budget:
                time.sleep(budget - dt)
    show(dec.finalize())
    view.set_status(phase="done", synced=bool(dec.synced))
    return dec, shown


def main(argv=None) -> int:
    import argparse
    from pathlib import Path

    ap = argparse.ArgumentParser(
        description="replay a capture through the streaming decoder with "
                    "a live constellation view")
    ap.add_argument("capture_dir", help="directory with rx{1,2}.dat")
    ap.add_argument("--port", type=int, default=8000)
    ap.add_argument("--chunk", type=int, default=1 << 16)
    ap.add_argument("--rate", type=float, default=2e6,
                    help="simulated arrival rate (samples/s aggregate); "
                         "0 = as fast as possible")
    ap.add_argument("--cpu", action="store_true",
                    help="decode on the CPU (default: CUDA)")
    ap.add_argument("--once", action="store_true",
                    help="exit after the replay instead of serving the "
                         "final state")
    ap.add_argument("--config", type=str, default=None,
                    help="ModemConfig JSON (else manifest.json / default)")
    args = ap.parse_args(argv)
    if not args.cpu and not torch.cuda.is_available():
        print("live_view: no CUDA device; pass --cpu to decode on the CPU",
              file=sys.stderr)
        return 2
    device = torch.device("cpu" if args.cpu else "cuda")

    from rub_mimo_tpu_torch.io import capture as capture_mod

    if args.config:
        cfg = ModemConfig.from_json(Path(args.config).read_text())
    else:
        manifest = Path(args.capture_dir) / "manifest.json"
        if manifest.exists():
            cfg = capture_mod.CaptureManifest.load(manifest).config
        else:
            cfg = ModemConfig()
    cap = capture_mod.read_capture(args.capture_dir, cfg.num_streams)
    view = LiveView(cfg, port=args.port)
    port = view.start()
    print(f"live view: http://127.0.0.1:{port}/  (ctrl-c to stop)",
          flush=True)
    try:
        dec, shown = replay(view, cap, cfg, device=device,
                            chunk_size=args.chunk, rate=args.rate)
        print(f"replay done: synced={bool(dec.synced)} "
              f"sync_index={dec.sync_index} frames={len(shown)}", flush=True)
        if not args.once:
            print("serving final state (ctrl-c to exit)", flush=True)
            while True:
                time.sleep(1)
    except KeyboardInterrupt:
        pass
    finally:
        view.stop()
    return 0


if __name__ == "__main__":
    sys.exit(main())
