"""The span recorder of rub_mimo_tpu_torch.utils.profiling: off it reads
no clock and keeps nothing; on, the served path's spans nest, one
capture's spans share a sequence number, the ring wraps and counts what
it drops, set-up spans and counters are kept, the served path's copies
are counted where they are issued, and the outputs are bit for bit
those of a decode with spans off.  On the card (``cuda``): the served
graph replays the decode's 7 device marks a capture in order, with
increasing stamps, only when spans were on at its capture, and its
outputs are those of the graph without marks.

This file imports neither jax nor the JAX package.
"""

import json

import pytest
import torch

from rub_mimo_tpu_torch import tiny_config
from rub_mimo_tpu_torch.io import simulator
from rub_mimo_tpu_torch.ofdm import fec
from rub_mimo_tpu_torch.pipeline import rx
from rub_mimo_tpu_torch.utils import profiling

CFG = tiny_config(bit_exact=False, pid_max=4)


@pytest.fixture
def rec(monkeypatch):
    """A fresh recorder, spans off, no device rings."""
    r = profiling.Recorder()
    monkeypatch.setattr(profiling, "REC", r)
    monkeypatch.setattr(profiling, "_on", False)
    monkeypatch.setattr(profiling, "_no_marks", 0)
    monkeypatch.setattr(profiling, "_device_marks", {})
    yield r
    profiling.disable_spans()


def _planes(device="cpu", seeds=(3, 9)):
    caps = []
    for seed in seeds:
        spec = simulator.ChannelSpec(snr_db=30.0, delay=400 + 37 * seed,
                                     seed=seed)
        caps.append(simulator.simulate_capture(CFG, spec, device="cpu")[0])
    T = min(c.shape[-1] for c in caps)
    stack = torch.stack([c[:, :T] for c in caps])
    return (stack.real.contiguous().to(device),
            stack.imag.contiguous().to(device))


def _serve(device="cpu"):
    return rx.make_serving_decoder(CFG, device=device, input_format="planes",
                                   sync_impl="pallas")


def _equal(a, b):
    for x, y in zip(a, b):
        assert (x is None) == (y is None)
        if x is not None:
            assert torch.equal(x.cpu(), y.cpu())


def test_off_reads_no_clock_and_keeps_nothing(rec, monkeypatch):
    def no_clock():
        raise AssertionError("a span site read the clock with spans off")

    monkeypatch.setattr(profiling, "_clock", no_clock)
    re, im = _planes()
    r = _serve()(re[:1], im[:1])
    fec.decode_payload(r.rx_sig[0], CFG)
    rx.decode((re[0], im[0]), CFG, sync_impl="pallas")
    assert rec.name is None and rec.n == 0 and rec.seq == 0
    assert rec.counters == {} and rec.setup == []
    snap = profiling.spans_snapshot()
    assert snap["spans"] == [] and snap["marks"] == []


def test_spans_nest_with_their_parents(rec):
    profiling.enable_spans()
    a = rec.begin("a")
    b = rec.begin("b")
    rec.finish(b)
    c = rec.begin("c")
    d = rec.begin("d")
    rec.finish(c)  # d left open (an exception): c's parent is open again
    rec.finish(a)
    e = rec.begin("e")
    rec.finish(e)
    spans = {s["name"]: s for s in profiling.spans_snapshot()["spans"]}
    assert [spans[k]["parent"] for k in "abcde"] == [-1, a, a, c, -1]
    assert spans["d"]["end_ns"] is None
    for k in "abce":
        assert spans[k]["start_ns"] <= spans[k]["end_ns"]
    assert spans["a"]["start_ns"] <= spans["b"]["start_ns"]
    assert spans["c"]["end_ns"] <= spans["a"]["end_ns"]


def test_served_spans_nest_and_share_a_capture_number(rec):
    re, im = _planes()
    serve = _serve()
    profiling.enable_spans()
    for i in range(2):
        serve(re[i:i + 1], im[i:i + 1])
    snap = profiling.spans_snapshot()
    spans = snap["spans"]
    assert [s["name"] for s in spans] == ["serve", "serve.prepare"] * 2
    for k in (0, 2):
        assert spans[k]["parent"] == -1
        assert spans[k + 1]["parent"] == spans[k]["index"]
    assert [s["seq"] for s in spans] == [1, 1, 2, 2]
    assert snap["counters"]["serve.captures"] == 2
    assert snap["counters"]["spans.dropped"] == 0


def test_a_stack_takes_a_number_a_capture(rec):
    re, im = _planes()
    profiling.enable_spans()
    _serve()(re, im)
    _serve()(re[:1], im[:1])
    spans = profiling.spans_snapshot()["spans"]
    assert [s["seq"] for s in spans if s["name"] == "serve"] == [1, 3]
    assert rec.counters["serve.captures"] == 3


def test_the_ring_wraps_and_counts_what_it_drops(monkeypatch):
    small = profiling.Recorder(size=4)
    monkeypatch.setattr(profiling, "REC", small)
    monkeypatch.setattr(profiling, "_on", False)
    profiling.enable_spans()
    try:
        for k in range(6):
            small.finish(small.begin(f"s{k}"))
        snap = profiling.spans_snapshot()
    finally:
        profiling.disable_spans()
    assert [s["name"] for s in snap["spans"]] == ["s2", "s3", "s4", "s5"]
    assert [s["index"] for s in snap["spans"]] == [2, 3, 4, 5]
    assert snap["counters"]["spans.dropped"] == 2


def test_outputs_equal_with_spans_on_and_off(rec):
    re, im = _planes()
    off = _serve()(re, im)
    off_one = rx.decode((re[0], im[0]), CFG, sync_impl="pallas")
    off_bits = fec.decode_payload(off.rx_sig[0], CFG)
    profiling.enable_spans()
    on = _serve()(re, im)
    on_one = rx.decode((re[0], im[0]), CFG, sync_impl="pallas")
    on_bits = fec.decode_payload(on.rx_sig[0], CFG)
    _equal(off, on)
    _equal(off_one, on_one)
    assert torch.equal(off_bits, on_bits)


def test_a_span_ends_when_its_function_raises(rec):
    re, _ = _planes()
    profiling.enable_spans()
    with pytest.raises(ValueError):
        _serve()(re)  # the planes format takes two stacks
    s = profiling.spans_snapshot()["spans"]
    assert [x["name"] for x in s] == ["serve", "serve.prepare"]
    assert s[0]["end_ns"] and s[1]["end_ns"] is None
    assert rec.open == -1


def test_copies_count_where_they_are_issued(rec):
    re, im = _planes()
    serve = _serve()
    profiling.enable_spans()
    serve(re, im)  # float32 on the CPU: as_tensor copies nothing
    assert rec.counters.get("serve.copies", 0) == 0
    serve(re.double(), im.numpy())  # a conversion; a shared array
    assert rec.counters["serve.copies"] == 1
    assert rec.counters["serve.bytes"] == re.nbytes


def test_what_as_tensor_copies():
    x = torch.zeros(3)
    assert not profiling.copied_by_as_tensor(x, torch.as_tensor(x))
    assert profiling.copied_by_as_tensor(
        x, torch.as_tensor(x, dtype=torch.float64))
    a = x.numpy()
    assert not profiling.copied_by_as_tensor(a, torch.as_tensor(a))
    assert profiling.copied_by_as_tensor([0.0], torch.as_tensor([0.0]))


def test_setup_spans_and_counters_are_kept_with_spans_off(rec):
    with profiling.setup_span("setup.graph"):
        with profiling.setup_span("setup.kernel_load", "lib"):
            pass
        with profiling.setup_span("setup.warm_decode"):
            pass
    profiling.count("serve.graph_captures")
    snap = profiling.spans_snapshot()
    assert [(s["name"], s["detail"], s["parent"]) for s in snap["setup"]] == [
        ("setup.graph", None, -1), ("setup.kernel_load", "lib", 0),
        ("setup.warm_decode", None, 0)]
    assert all(s["end_ns"] >= s["start_ns"] for s in snap["setup"])
    assert snap["counters"]["serve.graph_captures"] == 1
    assert snap["spans"] == []


def test_spans_record_while_a_profiler_records(rec):
    re, im = _planes()
    serve = _serve()
    serve(re[:1], im[:1])
    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU]):
        serve(re[:1], im[:1])
    serve(re[:1], im[:1])
    spans = profiling.spans_snapshot()["spans"]
    assert [s["name"] for s in spans] == ["serve", "serve.prepare"]
    assert not profiling._on


def test_device_stages_from_marks():
    def marks(seq, t0, device=0):
        return [{"device": device, "seq": seq, "mark": m, "ns": t0 + 1000 * k}
                for k, m in enumerate(profiling.MARKS)]

    got = profiling.device_stages(marks(1, 0) + marks(2, 10_000)
                                  + marks(3, 30_000)[:-1])
    assert [g["seq"] for g in got] == [1, 2]
    assert got[0]["stages_us"] == {s: 1.0 for s in profiling.STAGES}
    assert got[0]["gap_us"] is None and got[1]["gap_us"] == 4.0


def test_trace_writes_the_spans_beside_it(rec, tmp_path):
    """spans.json holds the served captures' spans, the counters and the
    marked decodes' stages (none on the CPU) beside trace.json."""
    re, im = _planes()
    serve = _serve()
    serve(re[:1], im[:1])
    with profiling.trace(str(tmp_path)):
        for i in range(2):
            serve(re[i:i + 1], im[i:i + 1])
    assert not profiling._on
    spans = json.loads((tmp_path / "spans.json").read_text())
    assert (tmp_path / "trace.json").exists()
    serves = [s for s in spans["spans"] if s["name"] == "serve"]
    assert len(serves) == 2
    assert all(s["start_ns"] <= s["end_ns"] for s in serves)
    assert spans["counters"]["serve.captures"] == 2
    assert spans["marks"] == [] and spans["device_stages"] == []


# ---- on the card ---------------------------------------------------------


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is "
                    "false)")
    return torch.device("cuda")


def _mark_kernels(fn):
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return [e.name for e in prof.events() if "span_mark_" in e.name]


@pytest.mark.cuda
def test_graph_replays_seven_marks_a_capture_in_order(rec):
    dev = _card()
    re, im = _planes(dev)
    profiling.enable_spans()
    serve = _serve(dev)
    serve(re[:1], im[:1])  # the graph's build and its first replay
    names = _mark_kernels(lambda: [serve(re[i:i + 1], im[i:i + 1])
                                   for i in range(2)])
    assert [n.split("(")[0].replace("void ", "") for n in names] == [
        f"span_mark_{m.split('.')[-1]}" for m in profiling.MARKS] * 2
    snap = profiling.spans_snapshot()
    by = {}
    for m in snap["marks"]:
        by.setdefault(m["seq"], []).append(m)
    host = sorted({s["seq"] for s in snap["spans"] if s["name"] == "serve"})
    assert sorted(by) == host == [1, 2, 3]
    for seq, ms in by.items():
        assert [m["mark"] for m in ms] == list(profiling.MARKS)
        assert all(a["ns"] <= b["ns"] for a, b in zip(ms, ms[1:]))
        assert ms[-1]["ns"] > ms[0]["ns"]
    stages = profiling.device_stages(snap["marks"])
    assert [s["seq"] for s in stages] == [1, 2, 3]
    assert all(s["gap_us"] is None or s["gap_us"] >= 0 for s in stages)


@pytest.mark.cuda
def test_graph_without_spans_has_no_marks_and_the_same_outputs(rec):
    dev = _card()
    re, im = _planes(dev)
    plain = _serve(dev)
    first = plain(re[:1], im[:1])
    launches = profiling.DeviceMarks.launches
    assert _mark_kernels(lambda: plain(re[1:], im[1:])) == []
    a = plain(re, im)
    profiling.enable_spans()
    marked = _serve(dev)
    marked(re[:1], im[:1])
    b = marked(re, im)
    profiling.disable_spans()
    assert _mark_kernels(lambda: plain(re, im)) == []
    assert profiling.DeviceMarks.launches > launches  # the capture's
    _equal(a, b)
    assert first.rx_data.shape[0] == 1


@pytest.mark.cuda
def test_the_card_counts_each_copy_of_serve(rec):
    dev = _card()
    re, im = _planes(dev)
    serve = _serve(dev)
    serve(re[:1], im[:1])
    outs = sum(o is not None for o in serve.graphs[tuple(re.shape[1:])]
               .outputs)
    profiling.enable_spans()
    serve(re, im)
    assert rec.counters["serve.copies"] == 2 * (2 + outs)
    serve(re.cpu(), im.cpu())  # two uploads more
    assert rec.counters["serve.copies"] == 2 * (2 + outs) + 2 + 2 * (2 + outs)


@pytest.mark.cuda
def test_an_eager_decode_takes_its_own_number(rec):
    dev = _card()
    re, im = _planes(dev)
    profiling.enable_spans()
    out = rx.decode((re[0], im[0]), CFG, sync_impl="pallas")
    torch.cuda.synchronize()
    snap = profiling.spans_snapshot()
    assert [m["mark"] for m in snap["marks"]] == list(profiling.MARKS)
    assert {m["seq"] for m in snap["marks"]} == {rec.seq} == {1}
    profiling.disable_spans()
    ref = rx.decode((re[0], im[0]), CFG, sync_impl="pallas")
    _equal(out, ref)
