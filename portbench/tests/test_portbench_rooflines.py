"""The kernels' bounds at the operating point, as PERF.md's kernel table
has them (H100 peaks: 3.35 TB/s, 67 TFLOP/s float32), and the share
read from a trace."""

from types import SimpleNamespace

import pytest

from portbench import roofline
from portbench.registry import Registry
from portbench.trace import Op, Trace

REG = Registry()
PEAKS = REG.peaks()


def us(n_bytes, flops):
    return roofline.least_seconds(n_bytes, flops, PEAKS) * 1e6


def test_k1_at_the_operating_point():
    k1 = REG.roofline("payload_fused_strip")
    n_bytes, flops = k1.bound(2, 1000, 2048, 32, emit_sig=True)
    assert us(n_bytes, flops) == pytest.approx(24.5, abs=0.05)
    assert n_bytes / PEAKS["hbm_bytes_per_s"] > flops / PEAKS[
        "fp32_flops_per_s"]


def test_viterbi_at_the_operating_point():
    vit = REG.roofline("viterbi")
    rows, span = vit.rows(2, 1000 * 2048, 5)
    assert (rows, span) == (2500, 4352)
    n_bytes, flops = vit.bound(rows, span)
    assert flops == pytest.approx(4.18e9, rel=1e-3)
    assert us(n_bytes, flops) == pytest.approx(62.4, abs=0.05)
    assert n_bytes == pytest.approx(130.6e6, rel=1e-3)


def test_soft_llr_rows_at_the_operating_point():
    llr = REG.roofline("soft_llr_rows")
    vit = REG.roofline("viterbi")
    n = 2 * 1000 * 2048
    n_bytes, flops = llr.bound(n, 5, *vit.rows(2, n // 2, 5))
    assert us(n_bytes, flops) == pytest.approx(35.8, abs=0.05)
    assert flops / PEAKS["fp32_flops_per_s"] * 1e6 == pytest.approx(
        20.5, abs=0.05)


def test_k5_counts_up_to_t_star():
    k5 = REG.roofline("sc_sync")
    n_bytes, flops = k5.bound(2, 7147)
    assert n_bytes == 2 * 7148 * 8
    assert us(n_bytes, flops) == pytest.approx(0.034, abs=0.0005)
    assert k5.bound(2, 2 * 7147)[0] > n_bytes


def fake_ctx(ops, pool_indices, t_star):
    win = Op("portbench.window", 0.0, 1000.0)
    tr = Trace(ops, [win], REG.layers(), pool_indices, {})
    md = SimpleNamespace(S=2)
    return SimpleNamespace(registry=REG, trace=tr, t_star=t_star, md=md)


def test_share_is_bound_over_kernel_time():
    ops = [Op("void sc_sync_scan(float2 const*)", 10.0, 20.0),
           Op("sc_sync_resolve", 20.0, 22.0),
           Op("sc_sync_scan", 100.0, 110.0), Op("sc_sync_resolve", 110, 112)]
    ctx = fake_ctx(ops, [0, 1], {0: 7147, 1: 7147})
    want = 100 * 2 * us(*REG.roofline("sc_sync").bound(2, 7147)) / 24.0
    assert roofline.share(ctx, "sc_sync") == pytest.approx(want)


def test_share_is_none_without_the_kernel():
    ctx = fake_ctx([Op("some_other_kernel", 1.0, 2.0)], [0], {0: 100})
    assert roofline.share(ctx, "sc_sync") is None
