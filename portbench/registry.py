"""Finding a cell's files by name.

``BENCHMARK.json`` names the cells, configurations and metrics; each
configuration's file, each traffic mix (``traffic/<name>.json``), each
metric's reader (``metrics/<name>.py``), each layer's kernel-name
patterns (``layers/<name>.json``) and each kernel's bound
(``rooflines/<kernel>.py``) is looked up by that name, and so is the
plain receiver that a configuration names (``reference/<name>.py``), so a
cell, a configuration, a metric, a layer or a kernel is added by adding
its files and entries.
"""

from __future__ import annotations

import importlib.util
import json
from pathlib import Path
from typing import Callable, NamedTuple

from portbench.reference import rx, tables

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


class Receiver(NamedTuple):
    """A configuration's plain receiver: what the generator, the check,
    the control and K5's bound take from the reference."""

    Modem: type             # Modem(modem dict): its gates, derived sizes
    Precision: type         # Precision("float64" | "float32" | "bfloat16")
    receive: Callable       # receive(x, md, precision, *, tie_band, coded)
    synchronize: Callable   # synchronize(x, md, p, tie_band) -> t_star, ...
    decode_bits: Callable   # decode_bits(y, md, p) -> (bits, tie margins)
    points: Callable        # points(modulation) -> the constellation


TODAY = Receiver(tables.Modem, rx.Precision, rx.receive,
                 rx.synchronize, rx.decode_bits, tables.points)


class Registry:
    """The benchmark's files under ``root`` (the checkout's root)."""

    def __init__(self, root: Path = ROOT, bench_dir: Path = HERE):
        self.root = Path(root)
        self.dir = Path(bench_dir)
        self.manifest = json.loads((self.root / "BENCHMARK.json").read_text())

    def cell(self, name: str) -> dict:
        for w in self.manifest["workloads"]:
            if w["name"] == name:
                return w
        raise KeyError(f"no workload named {name!r} in BENCHMARK.json")

    def config(self, name: str) -> dict:
        for c in self.manifest["configs"]:
            if c["name"] == name:
                return json.loads((self.root / c["file"]).read_text())
        raise KeyError(f"no config named {name!r} in BENCHMARK.json")

    def receiver(self, config: dict) -> Receiver:
        """The plain receiver of a configuration: ``reference/<name>.py``
        for its ``"reference": "<name>"``, each part of ``Receiver`` that
        the module does not define taken from ``reference.tables`` and
        ``reference.rx``; without the key, those of today's.  KeyError
        where no such module is there."""
        name = config.get("reference")
        if name is None:
            return TODAY
        path = self.dir / "reference" / f"{name}.py"
        if not (isinstance(name, str) and name.isidentifier()
                and path.is_file()):
            raise KeyError(f"no plain receiver named {name!r} "
                           f"(reference/<name>.py) for configuration "
                           f"{config.get('name')!r}")
        mod = _load(path)
        return TODAY._replace(**{k: getattr(mod, k) for k in Receiver._fields
                                 if hasattr(mod, k)})

    def traffic(self, name: str) -> dict:
        return json.loads((self.dir / "traffic" / f"{name}.json").read_text())

    def metrics(self, cell: str, trace: bool) -> list:
        """The cell's metric entries: its end-to-end metrics (trace off)
        or its per-layer metrics (trace on), each reported where its
        ``workloads`` list names the cell, or, with no list, in every cell
        that reports the metric it moves."""
        e2e = [m for m in self.manifest["end_to_end"]
               if cell in m.get("workloads", [cell])]
        if not trace:
            return e2e
        moved = {m["name"] for m in e2e}
        return [m for m in self.manifest["per_layer"]
                if cell in m.get("workloads", [cell]) and m["moves"] in moved]

    def reader(self, metric: str):
        """metrics/<metric>.py's ``read(ctx)``: the metric's value, or
        None where the run gives it nothing to read."""
        return _load(self.dir / "metrics" / f"{metric}.py").read

    def layers(self) -> dict:
        """layer name -> its file (``patterns``, optional ``stages`` and
        ``fallback``)."""
        return {p.stem: json.loads(p.read_text())
                for p in sorted((self.dir / "layers").glob("*.json"))}

    def roofline(self, kernel: str):
        return _load(self.dir / "rooflines" / f"{kernel}.py")

    def peaks(self) -> dict:
        return json.loads((self.dir / "rooflines" / "peaks.json").read_text())


def _load(path: Path):
    spec = importlib.util.spec_from_file_location(
        "portbench_" + path.stem.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod
