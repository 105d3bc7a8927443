"""File IQ ingest: the reference's binary log formats and the manifest.

Port of rub_mimo_tpu/io/capture.py (numpy in, numpy out; the files are
byte for byte those of the JAX package, so either package reads what the
other writes).  Formats, per mimo/apps/plot.py:27-40 and the reference's
fwrite call sites:

  raw IQ         : complex64 little-endian   (tx{n}.dat, rx{n}.dat)
  symbol streams : complex64                 (tx_sig{n}.dat, rx_sig{n}.dat)
  data streams   : uint32                    (tx_data{n}.dat, rx_data{n}.dat)
  sync metric    : float32                   (f_sc_{n}.dat)
  corr traces    : float32                   (corr_<chan>_<ac>.dat)

The JSON manifest records the radio and OFDM parameters a capture was
made with (the GUI's device-config store, Interface/usrp_device.cpp:
11-50), so a replay is self-describing.
"""

from __future__ import annotations

import dataclasses
import json
import os
from pathlib import Path
from typing import Dict, Optional

import numpy as np

from rub_mimo_tpu_torch.config import ModemConfig, check_config


def read_iq(path: str | os.PathLike, count: int = -1,
            offset: int = 0) -> np.ndarray:
    """Read a complex64 raw-IQ .dat file (the reference's rx{n}.dat)."""
    return np.fromfile(path, dtype=np.complex64, count=count,
                       offset=offset * 8)


def write_iq(path: str | os.PathLike, x: np.ndarray) -> None:
    np.asarray(x, dtype=np.complex64).tofile(path)


def read_data(path: str | os.PathLike, count: int = -1) -> np.ndarray:
    """Read a uint32 symbol-index file (tx_data{n}.dat / rx_data{n}.dat)."""
    return np.fromfile(path, dtype=np.uint32, count=count)


def write_data(path: str | os.PathLike, d: np.ndarray) -> None:
    np.asarray(d, dtype=np.uint32).tofile(path)


def read_metric(path: str | os.PathLike, count: int = -1) -> np.ndarray:
    """Read a float32 trace file (f_sc_{n}.dat / corr_*.dat)."""
    return np.fromfile(path, dtype=np.float32, count=count)


def write_metric(path: str | os.PathLike, m: np.ndarray) -> None:
    np.asarray(m, dtype=np.float32).tofile(path)


def _check_format(wire_format: str) -> None:
    if wire_format not in ("fc32", "sc16"):
        raise ValueError(f"unknown wire_format {wire_format!r}")


def read_capture(directory: str | os.PathLike, num_streams: int,
                 prefix: str = "rx", wire_format: str = "fc32") -> np.ndarray:
    """Load per-stream IQ files <prefix>{1..n}.dat into [streams, T]
    complex64.

    wire_format: "fc32" (complex64 on disk, the reference's CPU format)
    or "sc16" (UHD's wire format, interleaved int16, converted through
    io.native).  Streams are cut to the shortest file, as the reference
    consumes equal-length per-channel buffers."""
    _check_format(wire_format)
    directory = Path(directory)
    if wire_format == "fc32":
        chans = [read_iq(directory / f"{prefix}{i + 1}.dat")
                 for i in range(num_streams)]
    else:
        from rub_mimo_tpu_torch.io import native

        chans = [native.sc16_to_fc32(np.fromfile(
            directory / f"{prefix}{i + 1}.dat", dtype=np.int16))
            for i in range(num_streams)]
    n = min(len(c) for c in chans)
    return np.stack([c[:n] for c in chans])


def write_capture(directory: str | os.PathLike, x: np.ndarray,
                  prefix: str = "rx", wire_format: str = "fc32") -> None:
    """Write [streams, T] IQ as <prefix>{1..n}.dat in wire_format."""
    _check_format(wire_format)
    directory = Path(directory)
    directory.mkdir(parents=True, exist_ok=True)
    for i, chan in enumerate(np.asarray(x)):
        path = directory / f"{prefix}{i + 1}.dat"
        if wire_format == "fc32":
            write_iq(path, chan)
        else:
            from rub_mimo_tpu_torch.io import native

            native.fc32_to_sc16(chan).tofile(path)


@dataclasses.dataclass
class CaptureManifest:
    """Self-describing capture metadata (successor of dev_config.json)."""

    config: ModemConfig
    num_samples: int
    prefix: str = "rx"
    description: str = ""
    # e.g. {"type": "b200", "serial": "308F965", "addr": "", "product":
    # "B210"}, usrp_device's parsed fields (Interface/usrp_device.h:30-36)
    device: Dict[str, str] = dataclasses.field(default_factory=dict)

    def save(self, path: str | os.PathLike) -> None:
        check_config(self.config, "CaptureManifest.save")
        d = {
            "config": json.loads(self.config.to_json()),
            "num_samples": self.num_samples,
            "prefix": self.prefix,
            "description": self.description,
            "device": self.device,
        }
        Path(path).write_text(json.dumps(d, indent=2))

    @classmethod
    def load(cls, path: str | os.PathLike) -> "CaptureManifest":
        d = json.loads(Path(path).read_text())
        return cls(
            config=ModemConfig.from_json(json.dumps(d["config"])),
            num_samples=d["num_samples"],
            prefix=d.get("prefix", "rx"),
            description=d.get("description", ""),
            device=d.get("device", {}),
        )


def validate_capture(x: np.ndarray,
                     min_len: Optional[int] = None) -> Dict[str, bool]:
    """Named ingest checks of a capture: finite, nonempty, nonzero and,
    with min_len, long enough.  The reference has none (a bad capture
    never syncs and decodes nothing); callers raise or report."""
    x = np.asarray(x)
    checks = {
        "finite": bool(np.isfinite(x.view(np.float32)).all()),
        "nonempty": x.size > 0,
        "nonzero": bool(np.abs(x).max() > 0) if x.size else False,
    }
    if min_len is not None:
        checks["long_enough"] = x.shape[-1] >= min_len
    return checks
