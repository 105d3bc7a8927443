"""The harness on the CPU: files found by name, the end-to-end metrics'
arithmetic, the trace's layers, the import rules and the refusal to run
without a card."""

import ast
import json
import random
import shutil
import subprocess
import sys
import time
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from portbench import harness
from portbench.registry import HERE, ROOT, Registry
from portbench.tests import tiny
from portbench.trace import Op, Trace, TraceError, stage_ops

FORBIDDEN = {"jax", "jaxlib", "flax", "rub_mimo_tpu"}


def test_new_files_are_found_by_name(tmp_path):
    reg = tiny.tree(tmp_path)
    bench = tmp_path / "portbench"
    manifest = json.loads((tmp_path / "BENCHMARK.json").read_text())
    # a configuration, a traffic mix, a cell, a layer and a metric, each
    # by adding files and entries only
    cfg = json.loads((bench / "configs" / "tiny_ref.json").read_text())
    cfg["name"] = "tiny_new"
    (bench / "configs" / "tiny_new.json").write_text(json.dumps(cfg))
    (bench / "traffic" / "fresh.json").write_text(
        json.dumps(dict(tiny.TRAFFIC, pool=2)))
    (bench / "layers" / "aaa_new.json").write_text(
        json.dumps({"modules": "x", "patterns": ["new_kernel"]}))
    (bench / "metrics" / "new.metric.py").write_text(
        "def read(ctx):\n    return 42.0\n")
    manifest["configs"].append({"name": "tiny_new", "source": "tiny",
                                "file": "portbench/configs/tiny_new.json",
                                "reduced": [], "why": "tiny"})
    manifest["workloads"].append({"name": "tiny.new", "config": "tiny_new",
                                  "traffic": "fresh", "chips": 1,
                                  "why": "tiny"})
    manifest["per_layer"].append({"name": "new.metric", "unit": "count",
                                  "better": "lower", "source":
                                  "program_counter", "layer": "new",
                                  "moves": "iq_rate"})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(manifest))
    reg = Registry(tmp_path, bench)
    assert reg.config(reg.cell("tiny.new")["config"])["name"] == "tiny_new"
    assert reg.traffic("fresh")["pool"] == 2
    assert "aaa_new" in reg.layers()
    names = [m["name"] for m in reg.metrics("tiny.new", trace=True)]
    assert "new.metric" in names and "fec.viterbi_roofline" not in names
    assert "fec.viterbi_roofline" in [
        m["name"] for m in reg.metrics("tiny.fec", trace=True)]
    assert reg.reader("new.metric")(None) == 42.0
    tr = Trace([Op("void new_kernel<1>()", 0, 1)],
               [Op("portbench.window", 0, 2)], reg.layers(), [0], {})
    assert tr.layer_of(tr.ops[0]) == "aaa_new"


def test_every_manifest_metric_has_a_reader():
    reg = Registry()
    for m in reg.manifest["end_to_end"] + reg.manifest["per_layer"]:
        assert callable(reg.reader(m["name"]))
    for c in reg.manifest["workloads"]:
        reg.traffic(c["traffic"])
        reg.config(c["config"])


class FakePool:
    def __init__(self, P=4, S=2, T=1000):
        self.views = [(torch.zeros((1, S, T)), torch.zeros((1, S, T)))
                      for _ in range(P)]


def run_window(stall_at=None, seconds=0.3):
    def path(re, im):
        if stall_at is not None and path.n == stall_at:
            time.sleep(0.15)
        path.n += 1
        time.sleep(0.002)
        return {}
    path.n = 0
    res = harness.window(path, FakePool(), seconds, 2, 3,
                         random.Random(1), harness.HostClock())
    ctx = SimpleNamespace(window=res, samples_per_capture=2 * 1000)
    return res, ctx


def test_iq_rate_is_all_work_over_all_time():
    read = Registry().reader("iq_rate")
    res, ctx = run_window()
    assert read(ctx) == pytest.approx(
        res["completed"] * 2000 / res["wall_s"] / 1e6)
    assert len(res["latencies_ms"]) == res["completed"]
    stalled, sctx = run_window(stall_at=5)
    # the stall stays in the window: fewer captures in the same time
    assert read(sctx) < 0.8 * read(ctx)


def test_capture_p95_is_over_all_captures():
    read = Registry().reader("capture_p95_ms")
    lat = [1.0] * 900 + [20.0] * 100  # the slow captures come together
    ctx = SimpleNamespace(window={"latencies_ms": lat})
    assert read(ctx) == np.percentile(lat, 95) == 20.0
    # the median of ten chunks' 95th percentiles would hide them
    chunks = [np.percentile(lat[i:i + 100], 95) for i in range(0, 1000, 100)]
    assert np.median(chunks) == 1.0


def test_reservoir_keeps_a_seeded_sample():
    res, _ = run_window()
    kept = [n for n, _, _ in res["kept"]]
    assert len(kept) == 3 and len(set(kept)) == 3
    assert all(0 <= n < res["completed"] for n in kept)


def test_trace_layers_and_idle():
    reg = Registry()
    ops = [Op("Memcpy DtoD (Device -> Device)", 0, 10),
           Op("void sc_sync_scan(float2 const*)", 10, 12),
           Op("void at::native::vectorized_elementwise_kernel<4>()", 12, 40),
           Op("payload_fused_strip_kernel", 40, 100),
           Op("Memset (Device)", 150, 151)]
    host = [Op("cudaEventSynchronize", 100, 160),
            Op("cudaGraphLaunch", 160, 200)]
    tr = Trace(ops, host, reg.layers(), [0, 1], {})
    assert tr.layer_seconds("serving") == pytest.approx(11e-6)
    assert tr.layer_seconds("sync") == pytest.approx(2e-6)
    assert tr.layer_seconds("estimate") == pytest.approx(28e-6)
    assert tr.layer_seconds("tail") == pytest.approx(60e-6)
    assert tr.busy_s == pytest.approx(101e-6)
    assert tr.window_s == pytest.approx(200e-6)
    assert len(tr.kernels()) == 3
    bd = tr.breakdown()
    assert bd["device_ops"][0] == ["payload_fused_strip_kernel",
                                   pytest.approx(60e-6)]
    gaps = dict(bd["idle_gaps"])
    assert gaps["cudaEventSynchronize"] == pytest.approx(50e-6)
    assert gaps["cudaGraphLaunch"] == pytest.approx(49e-6)
    ctx = SimpleNamespace(trace=tr)
    # 101 µs busy of the 151 from the first operation's start to the
    # last's end
    assert reg.reader("device.idle")(ctx) == pytest.approx(
        100 * (1 - 101 / 151))
    assert reg.reader("serving.copy_us")(ctx) == pytest.approx(5.5)
    assert reg.reader("device.kernels_per_capture")(ctx) == 1.5


def staged_trace(reg, extra_mark=False):
    """Two coded captures: a record, the input copy and the graph's
    kernels, a record, the back end's kernels and a copy, a record."""
    host, dev = [], []
    t = 0.0
    corr = 1
    for cap in range(2):
        host.append(Op("cudaEventRecord", t, t + 1)); t += 2
        host.append(Op("cudaMemcpyAsync", t, t + 1, corr))
        dev.append(Op("Memcpy DtoD (Device -> Device)", t + 50, t + 60,
                       corr)); corr += 1; t += 2
        host.append(Op("cudaGraphLaunch", t, t + 1, corr))
        dev += [Op("at::native::vectorized_elementwise_kernel", t + 60,
                   t + 70, corr), Op("sc_sync_scan", t + 70, t + 72, corr)]
        corr += 1; t += 2
        host.append(Op("cudaEventRecord", t, t + 1)); t += 2
        if extra_mark:
            host.append(Op("cudaEventRecord", t, t + 1)); t += 2
        for name in ("at::native::vectorized_elementwise_kernel",
                     "viterbi_kernel", "Memcpy DtoD (Device -> Device)"):
            host.append(Op("cudaLaunchKernel", t, t + 1, corr))
            dev.append(Op(name, t + 80, t + 85, corr)); corr += 1; t += 2
        host.append(Op("cudaEventRecordWithFlags", t, t + 1)); t += 100
    return dev, host


def test_the_coded_back_ends_own_operations_are_its_layers():
    reg = Registry()
    dev, host = staged_trace(reg)
    ops = stage_ops(dev, host, 2, ("decode", "fec"))
    tr = Trace(ops, host, reg.layers(), [0, 1], {})
    assert [o.stage for o in ops[:3]] == ["decode"] * 3
    assert [o.stage for o in ops[3:6]] == ["fec"] * 3
    # the back end's elementwise kernel and its copy are the back end's,
    # the graph's elementwise kernel estimation's, its input copy serving's
    assert tr.layer_seconds("fec") == pytest.approx(2 * 15e-6)
    assert tr.layer_seconds("estimate") == pytest.approx(2 * 10e-6)
    assert tr.layer_seconds("serving") == pytest.approx(2 * 10e-6)
    assert tr.layer_seconds("sync") == pytest.approx(2 * 2e-6)
    with pytest.raises(TraceError):
        stage_ops(*staged_trace(reg, extra_mark=True), 2, ("decode", "fec"))


def test_a_name_two_layers_match_is_refused(tmp_path):
    reg = tiny.tree(tmp_path)
    (tmp_path / "portbench" / "layers" / "zzz_copies.json").write_text(
        json.dumps({"modules": "x", "patterns": ["^Memcpy"]}))
    reg = Registry(tmp_path, tmp_path / "portbench")
    tr = Trace([Op("sc_sync_scan", 1, 2)], [], reg.layers(), [0], {})
    assert tr.layer_seconds("sync") == pytest.approx(1e-6)
    tr = Trace([Op("Memcpy DtoD", 0, 1), Op("sc_sync_scan", 1, 2)], [],
               reg.layers(), [0], {})
    with pytest.raises(TraceError, match="serving"):
        tr.layer_seconds("sync")


def test_kernels_per_capture_counts_eager_launches_by_their_counter():
    reg = Registry()
    ops = [Op("viterbi_kernel", 0, 1), Op("viterbi_kernel", 2, 3),
           Op("some_graph_kernel", 3, 4)]
    tr = Trace(ops, [], reg.layers(), [0, 1, 2], {"viterbi_kernel": 3})
    # the trace lost one launch that the counter saw
    assert reg.reader("device.kernels_per_capture")(
        SimpleNamespace(trace=tr)) == 4 / 3
    tr.counter_deltas = {"viterbi_kernel": 0}
    assert reg.reader("device.kernels_per_capture")(
        SimpleNamespace(trace=tr)) == 1.0


def imports(path: Path) -> set:
    tree = ast.parse(path.read_text())
    out = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            out |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.module:
            out.add(node.module.split(".")[0])
    return out


def test_nothing_under_portbench_imports_jax_or_the_jax_package():
    files = sorted(HERE.rglob("*.py"))
    assert files
    for f in files:
        assert not imports(f) & FORBIDDEN, f
    # the port's name begins with the JAX package's: compared whole
    assert "rub_mimo_tpu_torch" in imports(HERE / "program.py")


REFERENCE_FILES = sorted(
    str(f.relative_to(HERE)) for f in (HERE / "reference").rglob("*")
    if f.is_file() and "__pycache__" not in f.parts)


@pytest.mark.parametrize("name", REFERENCE_FILES + [
    "pool.py", "compare.py", "roofline.py", "registry.py"])
def test_the_reference_imports_nothing_of_the_program(name):
    """Every file under reference/ (a receiver module a configuration
    names included) is Python that imports neither the program nor JAX."""
    f = HERE / name
    assert f.suffix == ".py", f
    assert not imports(f) & (FORBIDDEN | {"rub_mimo_tpu_torch"}), f


def test_only_the_registry_reaches_the_plain_receiver():
    """Outside registry.py and reference/, no module of the benchmark
    imports reference.rx or reference.tables: the harness, the check and
    the control take the receiver from ``Registry.receiver``."""
    for f in sorted(HERE.rglob("*.py")):
        rel = f.relative_to(HERE)
        if rel.parts[0] in ("reference", "tests") or rel == Path(
                "registry.py"):
            continue
        for node in ast.walk(ast.parse(f.read_text())):
            if isinstance(node, ast.ImportFrom) and node.module:
                names = [node.module + "." + a.name for a in node.names]
            elif isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            else:
                continue
            for n in names:
                assert not n.startswith(("portbench.reference.rx",
                                         "portbench.reference.tables")), \
                    (rel, n)


def test_forbidden_modules_compares_whole_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "rub_mimo_tpu_torch_fake", object())
    assert harness.forbidden_modules() == [
        m for m in ("jax", "jaxlib", "flax", "rub_mimo_tpu")
        if m in {k.split(".")[0] for k in sys.modules}]
    monkeypatch.setitem(sys.modules, "rub_mimo_tpu.fake", object())
    assert "rub_mimo_tpu" in harness.forbidden_modules()


def test_runner_refuses_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the refusal is for machines without")
    p = subprocess.run([sys.executable, "portbench/run.py", "--workload",
                        "ref2x2.replay", "--seed", str(2**31 + 5),
                        "--seconds", "1", "--trace", "0"], cwd=ROOT,
                       capture_output=True, text=True, timeout=300)
    assert p.returncode != 0
    assert p.stdout.strip() == ""
    assert "GPU" in p.stderr


def test_runner_fails_without_the_program(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(HERE, tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    p = subprocess.run([sys.executable, "portbench/run.py", "--workload",
                        "ref2x2.replay", "--seed", "1", "--seconds", "1",
                        "--trace", "0"], cwd=tmp_path, capture_output=True,
                       text=True, timeout=300)
    assert p.returncode != 0
    assert p.stdout.strip() == ""
