"""A benchmark tree at a size the CPU runs in seconds, for the tests.

``tree(tmp)`` copies the benchmark's layers, metrics, rooflines and
traffic into ``tmp/portbench`` and writes a BENCHMARK.json of two cells
on small configurations: ``tiny.replay`` (QPSK, M = 64) and
``tiny.fec`` (16-QAM, coded).  The configurations keep the real ones'
options and limits; only the sizes are cut.  ``add_cell`` adds one more
configuration and its cell to such a tree.
"""

from __future__ import annotations

import json
import shutil
from pathlib import Path

from portbench.registry import HERE, Registry

MODEM = {"num_subcarriers": 64, "cp_len": 16, "num_streams": 2,
         "num_access_codes": 4, "pid_max": 8}
TRAFFIC = {"why": "tiny", "pool": 3, "capture_samples": 4000,
           "delay": [200, 2000], "snr_db": 30.0,
           "in_flight": 2, "check_sample": 4}


def tree(tmp: Path) -> Registry:
    bench = Path(tmp) / "portbench"
    for sub in ("layers", "metrics", "rooflines", "traffic"):
        shutil.copytree(HERE / sub, bench / sub)
    (bench / "configs").mkdir()
    real = json.loads((HERE.parent / "BENCHMARK.json").read_text())
    cells, configs = [], []
    for name, src, mod in (("tiny_ref", "rub_ref_2x2", "qpsk"),
                           ("tiny_fec", "rub_2x2_qam16_fec", "qam16")):
        cfg = json.loads((HERE / "configs" / f"{src}.json").read_text())
        cfg["name"] = name
        cfg["modem"].update(MODEM, modulation=mod)
        path = bench / "configs" / f"{name}.json"
        path.write_text(json.dumps(cfg))
        configs.append({"name": name, "source": "tiny", "reduced": [],
                        "file": f"portbench/configs/{name}.json",
                        "why": "tiny"})
    (bench / "traffic" / "tiny.json").write_text(json.dumps(TRAFFIC))
    cells = [{"name": "tiny.replay", "config": "tiny_ref", "traffic": "tiny",
              "chips": 1, "why": "tiny"},
             {"name": "tiny.fec", "config": "tiny_fec", "traffic": "tiny",
              "chips": 1, "why": "tiny"}]
    manifest = dict(real, configs=configs, workloads=cells)
    for m in manifest["per_layer"]:
        if "workloads" in m:
            m["workloads"] = ["tiny.fec"]
    (Path(tmp) / "BENCHMARK.json").write_text(json.dumps(manifest))
    return Registry(Path(tmp), bench)


def add_cell(tmp: Path, name: str, modem=None, **top) -> Registry:
    """Add to ``tree(tmp)`` the configuration ``name`` (tiny_ref's, its
    modem updated by ``modem`` and its top level by ``top``) and the cell
    ``tiny.<name>`` of it on the tiny traffic; returns the registry."""
    bench = Path(tmp) / "portbench"
    cfg = json.loads((bench / "configs" / "tiny_ref.json").read_text())
    cfg["modem"].update(modem or {})
    cfg.update(top, name=name)
    (bench / "configs" / f"{name}.json").write_text(json.dumps(cfg))
    manifest = json.loads((Path(tmp) / "BENCHMARK.json").read_text())
    manifest["configs"].append({"name": name, "source": "tiny",
                                "file": f"portbench/configs/{name}.json",
                                "reduced": [], "why": "tiny"})
    manifest["workloads"].append({"name": f"tiny.{name}", "config": name,
                                  "traffic": "tiny", "chips": 1,
                                  "why": "tiny"})
    (Path(tmp) / "BENCHMARK.json").write_text(json.dumps(manifest))
    return Registry(Path(tmp), bench)
