"""The readers of the program's spans, counters and device marks
(``portbench/spans.py`` and the metrics that use it) on synthetic traces
built as ``test_portbench_harness.py`` builds them: the clock mapping on
anchors, serve()'s host time outside the trace's calls, the device
operations found by the correlation id of a launch inside a span, the
set-up split, and None from every new reader where the program gives no
spans (a commit before the recorder); the marks' bracketing of
estimation into stages (``scripts/trace_served.py``).  On the card
(``cuda``): the mapping holds within 5 µs on a traced served window."""

import importlib
import json
from types import SimpleNamespace

import pytest
import torch

from portbench import spans
from portbench.registry import ROOT, Registry
from portbench.trace import Op, Trace

NEW = ("serving.host_us", "serving.copies_per_capture",
       "serving.bytes_per_capture", "setup.graph_s", "setup.kernels_s",
       "setup.warm_decode_s")
OFFSET_US = 12_345.0  # trace µs = span ns / 1000 - OFFSET_US
PERIOD = 1000.0  # µs between two captures
# one capture's graph (µs after its base): name, start, end
GRAPH = [("span_mark_begin", 50, 51),
         ("at::native::elementwise_kernel", 52, 60),        # complex
         ("span_mark_complex", 61, 62),
         ("sc_sync_scan", 63, 70),
         ("at::native::reduce_kernel", 71, 73),             # sync: K5's ops
         ("span_mark_sync", 74, 75),
         ("vector_fft", 76, 80),                            # timing
         ("span_mark_timing", 81, 82),
         ("at::native::vectorized_elementwise_kernel", 83, 89),  # channel
         ("span_mark_channel", 90, 91),
         ("at::native::_scatter_gather_elementwise_kernel", 92, 99),  # window
         ("span_mark_window", 100, 101),
         ("payload_fused_strip_kernel", 102, 120),
         ("at::native::elementwise_kernel", 121, 122),      # tail
         ("span_mark_end", 123, 124)]


def ns(us: float) -> int:
    return int(round((us + OFFSET_US) * 1000))


def window(captures=2, marks=True, launch_shift=0.0):
    """(Trace, snapshot) of ``captures`` served captures: host calls, the
    graph's operations and the program's spans and counters."""
    dev, host, sp = [], [], []
    idx = 0

    def span(name, a, b, parent, seq):
        nonlocal idx
        sp.append({"index": idx, "name": name, "start_ns": ns(a),
                   "end_ns": ns(b), "parent": parent, "seq": seq})
        idx += 1
        return idx - 1

    for c in range(captures):
        B = c * PERIOD
        # correlation ids run against time: the output copy's is the
        # lower, so pairing by order would pick the wrong copy
        cin, cgraph, cout = 100 + 10 * c + 3, 100 + 10 * c + 2, 100 + 10 * c
        host += [Op("cudaMemcpyAsync", B + 1, B + 3, cin),
                 Op("cudaGraphLaunch", B + 5 + launch_shift,
                    B + 15 + launch_shift, cgraph),
                 Op("cudaMemcpyAsync", B + 16, B + 18, cout)]
        dev.append(Op("Memcpy DtoD (Device -> Device)", B + 40, B + 49, cin))
        for name, a, b in GRAPH:
            if marks or not name.startswith("span_mark_"):
                dev.append(Op(f"void {name}<float>(float*)", B + a, B + b,
                              cgraph))
        dev.append(Op("Memcpy DtoD (Device -> Device)", B + 130, B + 131,
                      cout))
        top = span("serve", B + 0.5, B + 19, -1, c + 1)
        span("serve.prepare", B + 0.6, B + 0.9, top, c + 1)
        span("serve.copy_in", B + 0.95, B + 4, top, c + 1)
        span("serve.replay", B + 4.5, B + 15.5, top, c + 1)
        span("serve.copy_out", B + 15.8, B + 18.5, top, c + 1)
    tr = Trace(dev, host, Registry().layers(), list(range(captures)), {})
    setup = [{"index": 0, "name": "setup.graph", "detail": None,
              "start_ns": 0, "end_ns": 10**9, "parent": -1, "seq": 0},
             {"index": 1, "name": "setup.warm_decode", "detail": None,
              "start_ns": 10**8, "end_ns": 4 * 10**8, "parent": 0, "seq": 0},
             {"index": 2, "name": "setup.kernel_load", "detail": "sc_sync",
              "start_ns": 10**8, "end_ns": 3 * 10**8, "parent": 1, "seq": 0},
             {"index": 3, "name": "setup.kernel_load", "detail": "viterbi",
              "start_ns": 2 * 10**9, "end_ns": 25 * 10**8, "parent": -1,
              "seq": 0}]
    snap = {"clock": "time.perf_counter_ns", "spans": sp, "setup": setup,
            "counters": {"serve.captures": captures,
                         "serve.copies": 2 * captures,
                         "serve.bytes": 3_000_000 * captures,
                         "serve.graph_captures": 1, "spans.dropped": 0,
                         "marks.dropped": 0},
            "marks": []}
    return tr, snap


def ctx_of(tr, snap):
    return SimpleNamespace(trace=tr, spans=snap)


def read(name, ctx):
    return Registry().reader(name)(ctx)


def test_the_new_metrics_are_in_the_manifest_with_readers():
    manifest = json.loads((ROOT / "BENCHMARK.json").read_text())
    names = [m["name"] for m in manifest["per_layer"]]
    assert names[-len(NEW):] == list(NEW)
    for name in NEW:
        assert callable(Registry().reader(name))


def test_every_new_reader_gives_none_without_the_programs_spans():
    tr, _ = window()
    for name in NEW:
        assert read(name, ctx_of(tr, None)) is None, name


def test_the_clock_is_fitted_on_graph_launches():
    tr, snap = window(captures=3)
    c = spans.clock(ctx_of(tr, snap))
    assert c.us(ns(7.0)) == pytest.approx(7.0, abs=1e-6)
    assert c.worst_us == 0.0
    assert spans.copy_check_us(ctx_of(tr, snap)) == 0.0
    # launches 6 µs late in their spans: the fitted line follows them,
    # and the input copies then fall outside their spans
    tr, snap = window(captures=3, launch_shift=6.0)
    c = spans.clock(ctx_of(tr, snap))
    assert c.worst_us == pytest.approx(0.0, abs=1e-6)
    assert spans.copy_check_us(ctx_of(tr, snap)) > 0


def test_a_launch_missing_from_the_trace_gives_no_mapping():
    tr, snap = window(captures=3)
    tr.host = [h for h in tr.host if h.corr != 112]
    assert spans.clock(ctx_of(tr, snap)) is None
    assert spans.launched_in(ctx_of(tr, snap), ("serve.copy_in",)) is None


def split_of(tr):
    return importlib.import_module("scripts.trace_served").estimate_split(tr)


def test_marks_bracket_estimation_into_stages(capsys):
    tr, snap = window(captures=2)
    split = split_of(tr)
    assert split == pytest.approx({"complex": 8, "sync": 2, "timing": 4,
                                   "channel": 6, "window": 7, "tail": 1,
                                   "marks": 7})
    err = capsys.readouterr().err
    assert "sync 2.000" in err and "tail 1.000" in err
    assert "marks 7.000" in err
    total = read("estimate.device_us", ctx_of(tr, snap))
    assert sum(split.values()) == pytest.approx(total)


def test_no_marks_no_split():
    without, _ = window(captures=2, marks=False)
    with_marks, _ = window(captures=2)
    assert split_of(without) is None
    assert read("estimate.device_us", ctx_of(with_marks, None)) == \
        pytest.approx(read("estimate.device_us", ctx_of(without, None)) + 7)


def test_copies_are_found_by_the_correlation_id_of_their_launch():
    tr, snap = window(captures=3)
    ops = spans.launched_in(ctx_of(tr, snap), ("serve.copy_in",))
    assert [o.corr for _, o in ops] == [103, 113, 123]
    assert all(o.name.startswith("Memcpy") for _, o in ops)
    assert all(h.name == "cudaMemcpyAsync" for h, _ in ops)
    # the profiler's buffer records carry ids that are no correlation
    tr.host.append(Op("Activity Buffer Request", 6, 7, 112))
    ops = spans.launched_in(ctx_of(tr, snap), ("serve",),
                            skip=("cudaGraphLaunch",))
    assert sorted(o.corr for _, o in ops) == [100, 103, 110, 113, 120, 123]


def test_serve_host_leaves_out_the_calls_once():
    tr, snap = window(captures=3)
    # a cuGraphLaunch nested in the cudaGraphLaunch counts once
    tr.host.append(Op("cuGraphLaunch", 6, 14, 0))
    # a call that starts before the span counts from its start
    tr.host.append(Op("Activity Buffer Request", 0, 1, 0))
    got = spans.serve_host(ctx_of(tr, snap))
    assert got[0] == pytest.approx((18.5, 0.5 + 2 + 10 + 2))
    assert got[1:] == pytest.approx([(18.5, 14.0)] * 2)


def test_host_us_copies_and_bytes():
    tr, snap = window(captures=3)
    ctx = ctx_of(tr, snap)
    assert read("serving.host_us", ctx) == pytest.approx(18.5 - 14)
    assert read("serving.copies_per_capture", ctx) == 2.0
    assert read("serving.bytes_per_capture", ctx) == pytest.approx(3.0)


def test_the_copy_count_is_checked_against_the_trace(capsys):
    tr, snap = window(captures=2)
    snap["counters"]["serve.copies"] = 6
    assert read("serving.copies_per_capture", ctx_of(tr, snap)) == 3.0
    err = capsys.readouterr().err
    assert "2.0 device operations a capture launched inside serve " \
        "spans outside the graph, 2.0 of them memcpy; by call: " \
        "cudaMemcpyAsync 2.0" in err
    assert "graph launches at most 0.000 us outside" in err


def test_setup_split():
    tr, snap = window()
    assert read("setup.graph_s", ctx_of(tr, snap)) == pytest.approx(0.8)
    assert read("setup.kernels_s", ctx_of(tr, snap)) == pytest.approx(0.7)
    assert read("setup.warm_decode_s", ctx_of(tr, snap)) == \
        pytest.approx(0.1)


def test_a_window_the_ring_overwrote_is_not_read(capsys):
    tr, snap = window(captures=3)
    snap["counters"]["spans.dropped"] = 4
    snap["spans"] = snap["spans"][2:]  # capture 1's serve and prepare gone
    assert read("serving.host_us", ctx_of(tr, snap)) is None
    assert "spans.dropped" in capsys.readouterr().err


def test_only_the_window_captures_are_read():
    tr, snap = window(captures=3)
    tr.pool_indices = tr.pool_indices[1:]
    tr.captures = 2
    tr.host = [h for h in tr.host if h.start >= PERIOD]
    assert [s["seq"] for s in spans.window(ctx_of(tr, snap))
            if s["name"] == "serve"] == [2, 3]
    assert spans.clock(ctx_of(tr, snap)) is not None


@pytest.mark.cuda
def test_the_mapping_holds_on_a_traced_served_window():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is "
                    "false)")
    from torch.profiler import ProfilerActivity, profile

    from rub_mimo_tpu_torch import tiny_config
    from rub_mimo_tpu_torch.io import simulator
    from rub_mimo_tpu_torch.pipeline import rx

    cfg = tiny_config(bit_exact=False, pid_max=4)
    cap = simulator.simulate_capture(
        cfg, simulator.ChannelSpec(snr_db=30.0, delay=500, seed=3),
        device="cuda")[0]
    re, im = cap.real[None].contiguous(), cap.imag[None].contiguous()
    serve = rx.make_serving_decoder(cfg, device="cuda",
                                    input_format="planes")
    for _ in range(3):
        serve(re, im)
    torch.cuda.synchronize()
    n = 50
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            serve(re, im)
        torch.cuda.synchronize()
    tr = Trace.from_profiler(prof, Registry().layers(), list(range(n)), {},
                             None)
    ctx = SimpleNamespace(trace=tr)
    c = spans.clock(ctx)
    assert c is not None and c.worst_us <= spans.TOL_US
    assert spans.copy_check_us(ctx) <= spans.TOL_US
    outs = sum(1 for o in serve(re, im) if o is not None)
    assert read("serving.copies_per_capture", ctx) == 2 + outs
    assert len(spans.launched_in(ctx, ("serve",), skip=("cudaGraphLaunch",))
               ) == (2 + outs) * n
    whole = spans.median([s for s, _ in spans.serve_host(ctx)])
    assert 0 < read("serving.host_us", ctx) < whole
