"""Device registry: the successor of the GUI's usrp_device model (port
of rub_mimo_tpu/io/devices.py, the standard library only; registries
written by either package read in the other).

Replicates Interface/usrp_device.{h,cpp}: parsing UHD address strings into
{type, id, serial, addr, product}, per-model default subdevice specs
(B210/X300/N200, mimo/config.h:44-48), modulation choices
(usrp_device.h:11-14), and JSON (de)serialization of device + OFDM
parameters (usrp_device.cpp:11-50).  In the file-replay framework a
"device" is provenance metadata attached to captures; discovery
enumerates a JSON registry instead of the UHD bus
(mainwindow.cpp:55-103's uhd::device::find).
"""

from __future__ import annotations

import dataclasses
import json
from pathlib import Path
from typing import Dict, List, Optional

# default subdevice specs per model (mimo/config.h:44-48)
SUBDEV_SPECS = {
    "b200": {"tx": "A:B A:A", "rx": "A:A A:B"},
    "x300": {"tx": "A:0 B:0", "rx": "A:0 B:0"},
    "usrp2": {"tx": "A:0", "rx": "A:0"},  # N200
}

# the reference lab's known radios (mimo/config.h:37-42)
KNOWN_DEVICES = [
    {"type": "usrp2", "addr": "134.147.118.212", "name": "N200_12"},
    {"type": "usrp2", "addr": "134.147.118.215", "name": "N200_15"},
    {"type": "x300", "addr": "134.147.118.216", "name": "X300A"},
    {"type": "x300", "addr": "134.147.118.217", "name": "X300B"},
    {"type": "b200", "serial": "308F955", "name": "B210_TX"},
    {"type": "b200", "serial": "308F965", "name": "B210_RX"},
]


@dataclasses.dataclass
class Device:
    """Parsed device identity + radio/OFDM parameters."""

    type: str = ""
    id: str = ""
    serial: str = ""
    addr: str = ""
    product: str = ""
    name: str = ""
    # radio/OFDM parameters the GUI persisted (usrp_device.cpp:11-50)
    center_frequency: float = 2450e6
    sample_rate: float = 1.0e6
    tx_gain: float = 67.0
    rx_gain: float = 45.0
    num_subcarriers: int = 2048
    cp_len: int = 152

    @classmethod
    def from_addr_string(cls, s: str) -> "Device":
        """Parse a UHD address string like
        'type=b200,serial=308F955,product=B210' (usrp_device.cpp parsing of
        uhd::device_addr_t::to_string())."""
        d = cls()
        for part in s.split(","):
            part = part.strip()
            if not part or "=" not in part:
                continue
            k, v = part.split("=", 1)
            k = k.strip()
            v = v.strip()
            if hasattr(d, k) and isinstance(getattr(d, k), str):
                setattr(d, k, v)
        return d

    @property
    def subdev_spec_tx(self) -> str:
        return SUBDEV_SPECS.get(self.type, {"tx": "A:0"})["tx"]

    @property
    def subdev_spec_rx(self) -> str:
        return SUBDEV_SPECS.get(self.type, {"rx": "A:0"})["rx"]

    def to_dict(self) -> Dict:
        return dataclasses.asdict(self)

    @classmethod
    def from_dict(cls, d: Dict) -> "Device":
        fields = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: v for k, v in d.items() if k in fields})


def find_devices(registry: Optional[str | Path] = None) -> List[Device]:
    """Device discovery: enumerate the JSON registry (replaces
    uhd::device::find over the bus; defaults to the reference lab's list)."""
    if registry is not None and Path(registry).exists():
        entries = json.loads(Path(registry).read_text())
    else:
        entries = KNOWN_DEVICES
    return [Device.from_dict(e) for e in entries]


def save_registry(devices: List[Device], path: str | Path) -> None:
    """Persist the device list (dev_config.json, mainwindow.cpp:131-149)."""
    Path(path).write_text(
        json.dumps([d.to_dict() for d in devices], indent=2)
    )


def load_registry(path: str | Path) -> List[Device]:
    return [Device.from_dict(e) for e in json.loads(Path(path).read_text())]
