"""Each configuration's plain receiver, found by name: the accepted
configurations get today's, a configuration may bring its own as a new
file, which the check and K5's t* then use, and an unknown name stops a
run before its pool is made.  On the CPU at a tiny size, through
``harness.run_cell`` with the program's served decode (eager)."""

import json
import time
from pathlib import Path

import pytest
import torch

from portbench import compare, harness, pool as pool_mod, roofline
from portbench.reference import rx, tables
from portbench.registry import Registry, TODAY
from portbench.tests import tiny
from portbench.trace import Op, Trace

SEED = 2**31 + 4321
ACCEPTED = [c["name"] for c in Registry().manifest["configs"]]
POLYS_4 = [0o20033, 0o20047, 0o20065, 0o20123]  # the program's for S = 4

LATE = '''"""Today's plain receiver with sync_index and t* two samples late."""
from portbench.reference import rx


def _late(out):
    return dict(out, sync_index=out["sync_index"] + 2,
                t_star=out["t_star"] + 2)


def synchronize(x, md, p, tie_band=0.0):
    return _late(rx.synchronize(x, md, p, tie_band))


def receive(x, md, precision="float64", **kw):
    return _late(rx.receive(x, md, precision, **kw))
'''


def run(reg, cell, trace=False):
    """A run whose window serves every capture of the pool twice."""
    return harness.run_cell(cell, SEED, 0.5, trace,
                            t_start=time.perf_counter(), registry=reg,
                            device="cpu", captures=2 * tiny.TRAFFIC["pool"])


def per_layer(tmp, entries) -> Registry:
    """The tree's per-layer metrics replaced by ``entries``."""
    path = Path(tmp) / "BENCHMARK.json"
    manifest = json.loads(path.read_text())
    manifest["per_layer"] = entries
    path.write_text(json.dumps(manifest))
    return Registry(Path(tmp), Path(tmp) / "portbench")


def fake_trace(kernels):
    """``harness.traced_window`` on the CPU: the window serves the pool
    twice and keeps one answer (the other captures' t* then come from
    the receiver's ``synchronize``); the trace holds one 4 µs launch of
    each of ``kernels`` a capture."""
    def traced(path, pool, seconds, depth, keep, rng, clock, reg,
               stages=("decode",)):
        res = harness.window(path, pool, None, depth, 1, rng, clock,
                             count=2 * len(pool.views))
        ops = [Op(k, 10.0 * (len(kernels) * j + m),
                  10.0 * (len(kernels) * j + m) + 4.0)
               for j in range(len(res["pool_indices"]))
               for m, k in enumerate(kernels)]
        return res, Trace(ops, [], reg.layers(), res["pool_indices"], {},
                          window_s=res["wall_s"])
    return traced


def t_stars(reg, cell, shift=0) -> dict:
    """Today's plain receiver's t* of each capture of the cell's pool."""
    config = reg.config(reg.cell(cell)["config"])
    md = tables.Modem(config["modem"])
    pool = pool_mod.make(md, tiny.TRAFFIC, SEED, "cpu")
    f64 = rx.Precision("float64")
    return {i: rx.synchronize(f64(pool.capture(i)), md, f64)["t_star"]
            + shift for i in range(tiny.TRAFFIC["pool"])}


@pytest.mark.parametrize("name", ACCEPTED)
def test_an_accepted_configuration_gets_todays_receiver(name):
    reg = Registry()
    config = reg.config(name)
    rcv = reg.receiver(config)
    assert "reference" not in config and rcv is TODAY
    assert (rcv.Modem, rcv.Precision, rcv.points) == (
        tables.Modem, rx.Precision, tables.points)
    assert (rcv.receive, rcv.synchronize, rcv.decode_bits) == (
        rx.receive, rx.synchronize, rx.decode_bits)
    modem = dict(config["modem"], **tiny.MODEM)
    md = rcv.Modem(modem)
    pool = pool_mod.make(md, tiny.TRAFFIC, SEED, "cpu",
                         bool(config.get("fec")))
    tie = config["limits"]["tie_band"]
    got = compare.reference_answers(pool, range(tiny.TRAFFIC["pool"]), rcv,
                                    md, config["limits"])
    assert any(g["synced"] for g in got.values())
    for i, g in got.items():
        want = rx.receive(pool.capture(i), tables.Modem(modem),
                          tie_band=tie)
        assert g.keys() == want.keys()
        for k, v in want.items():
            assert (torch.equal(g[k], v) if torch.is_tensor(v)
                    else g[k] == v), (i, k)


@pytest.fixture
def late_tree(tmp_path):
    """The tiny tree with ``tiny.tiny_late``: tiny_ref's configuration
    naming the test's own receiver module, written into the tree."""
    tiny.tree(tmp_path)
    (tmp_path / "portbench" / "reference").mkdir()
    (tmp_path / "portbench" / "reference" / "late_by_two.py").write_text(
        LATE)
    tiny.add_cell(tmp_path, "tiny_late", reference="late_by_two")
    return tmp_path


def test_a_configuration_brings_its_own_receiver(late_tree):
    reg = Registry(late_tree, late_tree / "portbench")
    rcv = reg.receiver(reg.config("tiny_late"))
    assert rcv.receive is not rx.receive
    assert rcv.synchronize is not rx.synchronize
    # what the module leaves out is today's
    assert (rcv.Modem, rcv.Precision, rcv.decode_bits, rcv.points) == (
        tables.Modem, rx.Precision, rx.decode_bits, tables.points)


@pytest.mark.parametrize("cell, shift", [("tiny.replay", 0),
                                         ("tiny.tiny_late", 2)])
def test_the_check_uses_the_configurations_receiver(late_tree, cell, shift):
    """The same served decode, judged against a receiver whose
    sync_index is two samples late, is not correct; without the key it
    is."""
    out = run(Registry(late_tree, late_tree / "portbench"), cell)
    assert out["correct"] is (shift == 0), out["checks"]
    assert (out["checks"]["sync_mismatches"]["value"] > 0) is bool(shift)


@pytest.mark.parametrize("cell, shift", [("tiny.replay", 0),
                                         ("tiny.tiny_late", 2)])
def test_k5s_t_star_comes_from_the_configurations_receiver(
        late_tree, monkeypatch, cell, shift):
    (late_tree / "portbench" / "metrics" / "probe.t_star.py").write_text(
        "def read(ctx):\n    return dict(ctx.t_star)\n")
    reg = per_layer(late_tree, [
        {"name": "probe.t_star", "unit": "count", "better": "lower",
         "source": "device_trace", "layer": "sync", "moves": "iq_rate"}])
    monkeypatch.setattr(harness, "traced_window", fake_trace(["x"]))
    out = run(reg, cell, trace=True)
    got = out["metrics"]["probe.t_star"]["value"]
    # one capture's t* through the check's answers, the rest through
    # the receiver's synchronize
    assert len(got) == tiny.TRAFFIC["pool"]
    assert got == t_stars(reg, cell, shift)


@pytest.mark.parametrize("name", ["nowhere", "../reference/rx", 7])
def test_an_unknown_receiver_stops_the_run_before_the_pool(tmp_path,
                                                           monkeypatch,
                                                           name):
    tiny.tree(tmp_path)
    reg = tiny.add_cell(tmp_path, "tiny_lost", reference=name)
    with pytest.raises(KeyError):
        reg.receiver(reg.config("tiny_lost"))

    def made(*a, **kw):
        raise AssertionError("the pool was made")
    monkeypatch.setattr(pool_mod, "make", made)
    with pytest.raises(harness.NoResult, match="no plain receiver"):
        harness.run_cell("tiny.tiny_lost", SEED, 0.5, False,
                         t_start=time.perf_counter(), registry=reg,
                         device="cpu", make_path=made, captures=1)


@pytest.fixture(scope="module")
def tree_4x4(tmp_path_factory):
    """A tiny 4 x 4 ZF configuration listing its 4 access-code
    polynomials, with K5's and K1's rooflines as its only per-layer
    metrics."""
    tmp = tmp_path_factory.mktemp("tiny4x4")
    tiny.tree(tmp)
    tiny.add_cell(tmp, "tiny_4x4", modem={"num_streams": 4,
                                          "lfsr_large_polys": POLYS_4})
    real = Registry().manifest["per_layer"]
    return per_layer(tmp, [m for m in real if m["name"] in (
        "sync.k5_roofline", "tail.k1_roofline")])


def test_four_streams_run_correct_with_the_program(tree_4x4):
    out = run(tree_4x4, "tiny.tiny_4x4")
    assert out["correct"], out["checks"]
    assert out["failed"] == 0 and out["attempted"] > 0


def test_four_streams_rooflines(tree_4x4, monkeypatch):
    monkeypatch.setattr(harness, "traced_window", fake_trace(
        ["sc_sync_scan", "payload_fused_strip_kernel"]))
    out = run(tree_4x4, "tiny.tiny_4x4", trace=True)
    reg = tree_4x4
    md = tables.Modem(reg.config("tiny_4x4")["modem"])
    assert md.S == 4
    peaks = reg.peaks()
    served = 2 * tiny.TRAFFIC["pool"]
    spent = served * 4e-6  # one 4 µs launch a capture
    t_star = t_stars(reg, "tiny.tiny_4x4")
    k5 = reg.roofline("sc_sync")
    want_k5 = 100 * sum(roofline.least_seconds(
        *k5.bound(4, t_star[i % tiny.TRAFFIC["pool"]]), peaks)
        for i in range(served)) / spent
    k1 = reg.roofline("payload_fused_strip")
    want_k1 = 100 * served * roofline.least_seconds(
        *k1.bound(4, md.n_sym, md.M, 4, True), peaks) / spent
    m = out["metrics"]
    assert m["sync.k5_roofline"]["value"] == pytest.approx(want_k5)
    assert m["tail.k1_roofline"]["value"] == pytest.approx(want_k1)
