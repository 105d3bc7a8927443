"""The port on an NVIDIA GPU: the CUDA kernels (K1 payload tail, K5 one-pass
sync, K6 S&C metric) against their plain PyTorch versions, and the decode
on the card against the decode on the CPU.  Every test here is marked
``cuda`` and skips without a GPU.

This file imports no jax, so it also runs where jax is not installed:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

from rub_mimo_tpu_torch import Detector, Modulation
from rub_mimo_tpu_torch.detect import zf
from rub_mimo_tpu_torch.io import simulator
from rub_mimo_tpu_torch.kernels import payload_fused as pf
from rub_mimo_tpu_torch.kernels import sc_metric as k6
from rub_mimo_tpu_torch.kernels import sc_sync as k5
from rub_mimo_tpu_torch.ofdm import constellation
from rub_mimo_tpu_torch.pipeline import report, rx
from rub_mimo_tpu_torch.utils import movsum
import torch_oracle as oracle

pytestmark = pytest.mark.cuda


def _tail_case(dev, M, cp, n_sym):
    p_re, p_im, G = oracle.random_tail_inputs(M + n_sym, 2, M, cp, n_sym)
    W, gain = zf.invert(torch.as_tensor(G, device=dev))
    args = (torch.as_tensor(p_re, device=dev),
            torch.as_tensor(p_im, device=dev), W, gain,
            constellation.table(Modulation.ARB32OPT),
            np.float32(1.0 / np.sqrt(M)))
    return args, dict(n_sym=n_sym, symbol_len=M + cp, cp_len=cp)


@pytest.mark.parametrize("M,cp,n_sym", [(2048, 152, 13), (64, 16, 8),
                                        (1024, 72, 5), (4096, 288, 3)])
def test_kernel_matches_plain_tail(M, cp, n_sym):
    dev = oracle.require_cuda()
    args, kw = _tail_case(dev, M, cp, n_sym)
    before = pf.payload_fused_strip.launches
    sig, data = pf.payload_fused_strip(*args, **kw)
    ref_sig, ref_data = pf.payload_tail_reference(*args, **kw)
    torch.cuda.synchronize()
    assert pf.payload_fused_strip.launches == before + 1
    assert data.dtype == torch.int32 and data.shape == ref_data.shape
    assert int((data != ref_data).sum()) == 0
    rms = float(torch.sqrt(torch.mean(ref_sig.abs() ** 2)))
    assert float((sig - ref_sig).abs().max()) <= 1e-4 * rms
    _, data_only = pf.payload_fused_strip(*args, emit_sig=False, **kw)
    assert torch.equal(data_only, data)


def test_kernel_rejects_what_it_cannot_take():
    dev = oracle.require_cuda()
    args, kw = _tail_case(dev, 64, 16, 4)
    p_re, p_im, W, gain, tab, norm = args
    with pytest.raises(ValueError):
        pf.payload_fused_strip(p_re.double(), p_im, W, gain, tab, norm, **kw)
    with pytest.raises(ValueError):
        pf.payload_fused_strip(p_re.cpu(), p_im, W, gain, tab, norm, **kw)
    with pytest.raises(ValueError):
        pf.payload_fused_strip(p_re, p_im, W, gain,
                               constellation.table(Modulation.QAM256), norm,
                               **kw)


def _capture(cfg, **spec_kw):
    spec = simulator.ChannelSpec(**{**dict(snr_db=30.0, seed=11), **spec_kw})
    return simulator.simulate_capture(cfg, spec, device="cpu")[0]


def _dc_run_capture(T=60_000, late=50_000):
    """Stream 0 is a constant (metric 1 from t = M on); stream 1 is noise
    until ``late``, then constant: the fire comes ~late + M + cp, with
    stream 0's run reaching back over many tiles."""
    rng = np.random.default_rng(4)
    x = np.full((2, T), 0.5 + 0.25j, np.complex64)
    x[1, :late] = (rng.standard_normal(late)
                   + 1j * rng.standard_normal(late)).astype(np.complex64)
    return torch.as_tensor(x)


# TINY is M=64 (4032-sample tiles), MID M=2048 (2048-sample tiles)
SYNC_CASES = {
    "d501": lambda: (oracle.TINY, _capture(oracle.TINY, delay=501)),
    "d130_snr30": lambda: (oracle.TINY, _capture(oracle.TINY, delay=130)),
    "d2000_snr25": lambda: (oracle.TINY, _capture(oracle.TINY, delay=2000,
                                                  snr_db=25.0)),
    "d64_first_tile": lambda: (oracle.TINY, _capture(oracle.TINY, delay=64)),
    "late_fire": lambda: (oracle.TINY, _capture(oracle.TINY, delay=40_400,
                                                trailing=100)),
    "noise_only": lambda: (oracle.TINY, torch.as_tensor(
        (0.01 * np.random.default_rng(0).standard_normal((2, 9000, 2)))
        .astype(np.float32).view(np.complex64)[..., 0])),
    "leading_zeros": lambda: (oracle.TINY, torch.nn.functional.pad(
        _capture(oracle.TINY, delay=300), (100_000, 0))),
    "run_across_tiles": lambda: (oracle.TINY, _dc_run_capture()),
    "mid": lambda: (oracle.MID, _capture(oracle.MID, delay=7000)),
}


@pytest.mark.parametrize("case", list(SYNC_CASES))
def test_sc_sync_kernel_matches_plain(case):
    dev = oracle.require_cuda()
    cfg, x = SYNC_CASES[case]()
    x = x.to(dev)
    args = (x, cfg.M, cfg.cp_len, cfg.plateau_threshold)
    before = k5.sc_sync_fused.launches
    got = k5.sc_sync_fused(*args)
    ref = k5.sc_sync_reference(*args)
    torch.cuda.synchronize()
    assert k5.sc_sync_fused.launches == before + 1
    for a, b, name in zip(got[:3], ref[:3], ("synced", "t_star", "starts")):
        assert a.dtype == b.dtype, name
        np.testing.assert_array_equal(oracle.n(a), oracle.n(b), err_msg=name)
    cfo = [float(torch.angle((-c).sum()) / np.pi) for c in (got[3], ref[3])]
    assert abs(cfo[0] - cfo[1]) < 1e-4
    if case != "noise_only":
        assert bool(got[0])


@pytest.mark.parametrize("M,T", [(64, 100_777), (2048, (1 << 20) + 777),
                                 (4096, 50_000)])
def test_sc_metric_kernel_matches_plain(M, T):
    dev = oracle.require_cuda()
    rng = np.random.default_rng(T)
    x = torch.as_tensor((rng.standard_normal((2, T))
                         + 1j * rng.standard_normal((2, T)))
                        .astype(np.complex64), device=dev)
    x[:, 5000:5000 + 3 * M] = 0  # an all-zero stretch
    before = k6.sc_metric_fused.launches
    got = k6.sc_metric_fused(x, M)
    ref = k6.sc_metric_reference(x, M)
    _, energy = k6.moving_corr_energy(x, M)
    torch.cuda.synchronize()
    assert k6.sc_metric_fused.launches == before + 1
    assert got.dtype == torch.float32 and got.shape == ref.shape
    # 0/0 exactly on the windows of zeros (counted in integers)
    zeros = movsum.moving_sum((x != 0).to(torch.int64), M) == 0
    assert bool(zeros.any())
    np.testing.assert_array_equal(oracle.n(torch.isnan(got)), oracle.n(zeros))
    # elsewhere the tolerance of the JAX package's kernel test, on samples
    # whose plain energy is not a cancellation residue
    ok = torch.isfinite(ref) & (energy >= 1e-6 * energy.median())
    np.testing.assert_allclose(oracle.n(got[ok]), oracle.n(ref[ok]),
                               rtol=2e-3, atol=1e-4)


def test_sync_kernels_reject_what_they_cannot_take():
    dev = oracle.require_cuda()
    x = torch.zeros((2, 1000), dtype=torch.complex64, device=dev)
    for bad in (x.to(torch.complex128), x[:, ::2], x[0]):
        with pytest.raises(ValueError):
            k6.sc_metric_fused(bad, 64)
        with pytest.raises(ValueError):
            k5.sc_sync_fused(bad, 64, 16, 0.95)
    for M in (48, 8192):
        with pytest.raises(ValueError):
            k6.sc_metric_fused(x, M)
        with pytest.raises(ValueError):
            k5.sc_sync_fused(x, M, 16, 0.95)
    with pytest.raises(ValueError):
        k5.sc_sync_fused(torch.zeros((9, 1000), dtype=torch.complex64,
                                     device=dev), 64, 16, 0.95)


@pytest.mark.parametrize("cfg", [oracle.TINY, oracle.MID],
                         ids=["tiny", "mid"])
def test_decode_on_card_matches_cpu(cfg):
    dev = oracle.require_cuda()
    spec = simulator.ChannelSpec(snr_db=30.0, delay=3000, seed=3)
    cap, tx, _ = simulator.simulate_capture(cfg, spec, device="cpu")
    on_cpu = rx.make_decoder(cfg, device="cpu")(cap)
    before = pf.payload_fused_strip.launches
    on_card = rx.make_decoder(cfg, device=dev, input_format="planes")(
        cap.real.contiguous(), cap.imag.contiguous())
    assert pf.payload_fused_strip.launches == before + 1
    for f in ("synced", "sync_index", "sync_sample", "plateau_start",
              "s0_index", "ac_index", "decode_start", "rx_data",
              "symbol_valid"):
        np.testing.assert_array_equal(oracle.n(getattr(on_card, f)),
                                      oracle.n(getattr(on_cpu, f)),
                                      err_msg=f)
    np.testing.assert_allclose(oracle.n(on_card.G), oracle.n(on_cpu.G),
                               rtol=1e-4, atol=1e-6)
    assert report.score(on_card, tx, cfg).symbol_error_rate == [0.0, 0.0]


# (config change, capture options, decoder options, (K5, K6) launches)
CARD_OPTION_CASES = {
    "sync_pallas": (dict(), dict(), dict(sync_impl="pallas"), (1, 0)),
    "keep_debug": (dict(), dict(), dict(keep_debug=True), (0, 1)),
    "cfo_options": (dict(correct_cfo=True, sync_fallback=True,
                         smooth_channel=True, bit_exact=False,
                         detector=Detector.MMSE, mmse_auto_noise=True),
                    dict(cfo_subcarriers=0.05), dict(), (0, 0)),
}


@pytest.mark.parametrize("case", list(CARD_OPTION_CASES))
@pytest.mark.parametrize("cfg", [oracle.TINY, oracle.MID],
                         ids=["tiny", "mid"])
def test_decode_options_on_card_match_cpu(cfg, case):
    dev = oracle.require_cuda()
    change, cap_kw, kw, (n5, n6) = CARD_OPTION_CASES[case]
    cfg = cfg.replace(**change)
    spec = simulator.ChannelSpec(snr_db=30.0, delay=3000, seed=3, **cap_kw)
    cap, tx, _ = simulator.simulate_capture(cfg, spec, device="cpu")
    on_cpu = rx.make_decoder(cfg, device="cpu", **kw)(cap)
    counts = (k5.sc_sync_fused, k6.sc_metric_fused, pf.payload_fused_strip)
    before = [c.launches for c in counts]
    on_card = rx.make_decoder(cfg, device=dev, input_format="planes", **kw)(
        cap.real.contiguous(), cap.imag.contiguous())
    torch.cuda.synchronize()
    assert [c.launches - b for c, b in zip(counts, before)] == [n5, n6, 1]
    for f in ("synced", "sync_index", "sync_sample", "plateau_start",
              "plateau_end", "s0_index", "ac_index", "decode_start",
              "rx_data", "symbol_valid"):
        np.testing.assert_array_equal(oracle.n(getattr(on_card, f)),
                                      oracle.n(getattr(on_cpu, f)),
                                      err_msg=f)
    np.testing.assert_allclose(oracle.n(on_card.G), oracle.n(on_cpu.G),
                               rtol=1e-4, atol=1e-6)
    assert abs(float(on_card.cfo_hat) - float(on_cpu.cfo_hat)) < 1e-4
    if case == "keep_debug":
        m, ref = on_card.metric, on_cpu.metric
        assert m.dtype == torch.float32 and m.shape == cap.shape
        near = ref > 0.5  # the metric is read only near its threshold
        np.testing.assert_allclose(oracle.n(m.cpu()[near]),
                                   oracle.n(ref[near]), rtol=0, atol=1e-5)
    if case == "cfo_options":
        assert abs(float(on_card.cfo_hat) - 0.05) < 1e-3
    assert report.score(on_card, tx, cfg).symbol_error_rate == [0.0, 0.0]
