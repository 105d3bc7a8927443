"""The soft-LLR rows (rub_mimo_tpu_torch.kernels.soft_llr.soft_llr_rows)
on the CPU, with no jax.

``soft_llr_rows_plain`` must equal the port's composition (the LLRs of
constellation.soft_demodulate_llr, fec.deinterleave, fec.depuncture_llrs,
fec.viterbi_rows) bit for bit, for every rate, interleave on and off and
window None and 4096, on tiny_config and ModemConfig(pid_max=12), for
symbols and for LLRs.  ``rows_emulation`` replays the kernel's index plan
(tiles, residue runs, item slots, stage, strided stores) on integer
indices and must equal np.argsort(perm) followed by the depuncture and
window maps, at the operating point's full geometry (10,240,000 LLRs a
lane) at rates 1/2, 2/3 and 3/4: the guard on the kernel's 64-bit index
arithmetic.  The kernel itself is held against the plain version on the
card in tests/test_torch_cuda.py and chip_smoke.py.  Also here:
parallel.multiprocess.launch refuses CUDA without a card."""

import numpy as np
import pytest
import torch

from rub_mimo_tpu_torch import ModemConfig, Modulation, tiny_config
from rub_mimo_tpu_torch.kernels import soft_llr as ks
from rub_mimo_tpu_torch.ofdm import constellation, fec

RATES = ("1/2", "2/3", "3/4")
OPERATING_POINT = ModemConfig(pid_max=1000, bit_exact=False)


def lane_symbols(cfg, seed: int) -> torch.Tensor:
    """Seeded symbols [2, pid_max * M_occupied] around the table, with
    NaN, +-Inf and 1e30 in lane 0."""
    N = cfg.pid_max * cfg.M_occupied
    rng = np.random.default_rng(seed)
    y = ((rng.standard_normal((2, N)) + 1j * rng.standard_normal((2, N)))
         * 0.8).astype(np.complex64)
    y[0, 5:10] = [np.nan, np.inf, -np.inf, 1e30, complex(0.0, np.nan)]
    return torch.as_tensor(y)


def same(a: torch.Tensor, b: torch.Tensor) -> bool:
    return a.shape == b.shape and a.dtype == b.dtype and bool(
        ((a == b) | (torch.isnan(a) & torch.isnan(b))).all())


def composition(llrs, plan):
    """The coded decode's front half as fec's own functions compose it."""
    if plan.stride > 1:
        llrs = fec.deinterleave(llrs, fec.INTERLEAVE_SPREAD)
    kept = fec._kept_bits(plan.used, plan.rate)
    return fec.viterbi_rows(
        fec.depuncture_llrs(llrs[:, :kept], plan.used, plan.rate),
        plan.window, plan.margin)


@pytest.mark.parametrize("window", [None, 4096], ids=["one_row", "w4096"])
@pytest.mark.parametrize("interleave", [True, False],
                         ids=["interleaved", "plain"])
@pytest.mark.parametrize("rate", RATES)
@pytest.mark.parametrize("cfg", [tiny_config(), ModemConfig(pid_max=12)],
                         ids=["tiny", "pid12"])
def test_plain_rows_equal_the_composition(cfg, rate, interleave, window):
    y = lane_symbols(cfg, 7)
    tab = constellation.table(cfg.modulation)
    n = y.shape[1] * cfg.modulation.bits_per_symbol
    plan = fec.row_plan(n, cfg, rate, interleave)._replace(window=window)
    assert plan.stride == (fec.interleave_stride(n, 127) if interleave
                           else 1)
    before = ks.soft_llr_rows.launches
    for nv in (0.37, torch.tensor(0.37)):
        llrs = constellation.soft_demodulate_llr(y, cfg.modulation, nv)
        want, want_pin = composition(llrs.reshape(2, -1), plan)
        got, pin = ks.soft_llr_rows(y, plan, tab, nv)
        assert same(got, want) and torch.equal(pin, want_pin)
        # the LLR-input instance on the same LLRs
        got, pin = ks.soft_llr_rows(llrs.reshape(2, -1), plan)
        assert same(got, want) and torch.equal(pin, want_pin)
    assert torch.isnan(want).any() and (want == 0).any() == (rate != "1/2")
    assert ks.soft_llr_rows.launches == before


def reference_rows(plan: ks.RowPlan, n: int):
    """[rows, out_len] wire index of each float of a lane's rows (-1 a pad,
    -2 a puncture zero) from np.argsort(perm) and the depuncture and
    window maps, as a sliding view."""
    s = plan.stride
    wire = (np.argsort((np.arange(n, dtype=np.int64) * s) % n) if s > 1
            else np.arange(n, dtype=np.int64))
    pat = fec.PUNCTURE[plan.rate]
    kept = fec._kept_bits(plan.used, plan.rate)
    if pat is None:
        mother = wire[:plan.used]
    else:
        mask = np.tile(np.asarray(pat, bool), -(-plan.used // len(pat)))
        mother = np.full(plan.used, -2, np.int64)
        mother[mask[:plan.used]] = wire[:kept]
    T = plan.used // 2
    if plan.window is None:
        return mother[None, :2 * T]
    W, m = plan.window, plan.margin
    nW = -(-T // W)
    padded = np.full(2 * (nW * W + 2 * m), -1, np.int64)
    padded[2 * m: 2 * m + 2 * T] = mother[:2 * T]
    return np.lib.stride_tricks.sliding_window_view(
        padded, 2 * (W + 2 * m))[::2 * W]


def check_plan(plan: ks.RowPlan, n: int, lane_in: int, bits: int,
               chunk: int = 256):
    g = ks.row_geometry(plan, n, lane_in)
    want = reference_rows(plan, n)
    assert want.shape == (g.rows, g.out_len)
    for r0 in range(0, g.rows, chunk):
        rows = np.arange(r0, min(r0 + chunk, g.rows))
        got = ks.rows_emulation(g, bits, rows)
        np.testing.assert_array_equal(got, want[rows])
    return g


@pytest.mark.parametrize("instance", ["symbols", "llrs"])
@pytest.mark.parametrize("rate", RATES)
def test_index_plan_at_the_operating_point(rate, instance):
    """The kernel's index plan at the operating point's full geometry: 2 x
    2,048,000 ARB32OPT symbols, n = 10,240,000 LLRs a lane, stride 127,
    windows of 4096 + 2 x 128 steps (used up to 15.36 M at rate 3/4)."""
    cfg = OPERATING_POINT
    N = cfg.pid_max * cfg.M_occupied
    bits = cfg.modulation.bits_per_symbol
    n = N * bits
    plan = fec.row_plan(n, cfg, rate, True)
    assert (n, plan.stride, plan.window) == (10_240_000, 127, 4096)
    g = check_plan(plan, n, N if instance == "symbols" else n,
                   bits if instance == "symbols" else 0)
    assert g.rows == -(-plan.used // 2 // 4096) and g.tiles == 1


@pytest.mark.parametrize("bits", [0, 1, 2, 5, 8])
@pytest.mark.parametrize("rate", RATES)
@pytest.mark.parametrize("window", [None, 64], ids=["one_row", "w64"])
def test_index_plan_small(window, rate, bits):
    """Short lanes: rows of several tiles (window None past TILE floats),
    windows with margins wider than the lane, odd strides, every bit
    width."""
    for n, used, stride in ((40_000, 17_000, 131), (3_001, 1_000, 127),
                            (9_000, 8_000, 1)):
        if bits > 1:
            n -= n % bits
        used -= used % 2
        if np.gcd(stride, n) != 1:
            stride = fec.interleave_stride(n, stride)
        plan = ks.RowPlan(used=used, rate=rate, stride=stride,
                          window=window, margin=96)
        if fec._kept_bits(used, rate) > n:
            continue
        check_plan(plan, n, n // max(bits, 1), bits)


@pytest.mark.parametrize("bits", [1, 2, 5, 8])
def test_identity_plan_is_wire_order(bits):
    """soft_llr's geometry: one row of every LLR in wire order, in tiles."""
    for N in (1, 7, 1741, 100_003):
        g = ks.identity_geometry(N, bits)
        got = ks.rows_emulation(g, bits)
        np.testing.assert_array_equal(got[0], np.arange(N * bits))


def test_soft_llr_rows_rejects_what_the_kernel_cannot_take():
    cfg = tiny_config()
    y = lane_symbols(cfg, 3)
    tab = constellation.table(cfg.modulation)
    n = y.shape[1] * cfg.modulation.bits_per_symbol
    plan = fec.row_plan(n, cfg)
    for bad in (y.to(torch.complex128), y.real.to(torch.float64),
                y.reshape(-1), y[:0]):
        with pytest.raises(ValueError):
            ks.soft_llr_rows(bad, plan, tab)
    with pytest.raises(ValueError):
        ks.soft_llr_rows(y.real.contiguous(), plan, tab)  # LLRs and points
    with pytest.raises(ValueError):
        ks.soft_llr_rows(y.to("meta"), plan, tab)
    with pytest.raises(ValueError):
        ks.soft_llr_rows(y, plan, np.zeros(3, np.complex64))
    with pytest.raises(ValueError):  # fewer LLRs than the rows keep
        ks.row_geometry(plan, plan.used - 1, plan.used)
    with pytest.raises(ValueError):  # a stride that is not coprime to n
        ks.row_geometry(plan._replace(stride=2), n - n % 2, n)
    with pytest.raises(ValueError):
        ks.row_geometry(plan._replace(stride=ks.MAX_STRIDE + 1), n, n)
    with pytest.raises(ValueError):
        ks.row_geometry(plan._replace(rate="5/6"), n, n)


def test_decode_payload_on_cpu_is_the_composition():
    """decode_payload and _decode_from_llrs on the CPU give the bits of
    viterbi_decode over the composed LLRs, counting no launch."""
    cfg = ModemConfig(pid_max=12, modulation=Modulation.QPSK)
    y = lane_symbols(cfg, 11)
    llrs = constellation.soft_demodulate_llr(y, cfg.modulation, 0.5)
    for rate in RATES:
        plan = fec.row_plan(llrs[0].numel(), cfg, rate)
        T = plan.used // 2
        x = fec.deinterleave(llrs.reshape(2, -1), fec.INTERLEAVE_SPREAD)
        want = fec.viterbi_decode(fec.depuncture_llrs(
            x[:, :fec._kept_bits(plan.used, rate)], plan.used, rate),
            window=plan.window)
        before = ks.soft_llr_rows.launches
        got = fec.decode_payload(y, cfg, 0.5, rate=rate)
        assert torch.equal(got, want) and got.shape == (2, T - fec.TAIL)
        assert torch.equal(
            fec._decode_from_llrs(llrs.reshape(2, -1), cfg, True, rate), want)
        assert ks.soft_llr_rows.launches == before


def test_multiprocess_launch_defaults_to_cuda_and_refuses_without_it(
        monkeypatch):
    """launch() with no device asks for CUDA (NCCL) and, without a card,
    raises naming device="cpu" before it starts any process."""
    from rub_mimo_tpu_torch.parallel import multiprocess

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    started = []
    monkeypatch.setattr(multiprocess.subprocess, "Popen",
                        lambda *a, **k: started.append(a))
    with pytest.raises(RuntimeError, match='device="cpu"'):
        multiprocess.launch()
    with pytest.raises(RuntimeError, match='device="cpu"'):
        multiprocess.launch(device="cuda:0", backend="gloo")
    assert not started
