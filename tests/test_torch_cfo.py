"""Port parity of the acquisition front end's modules: the simulator's CFO,
the CFO de-rotation and estimators, the S0 cross-correlation fallback,
the window gather, delay-domain smoothing, the noise-variance estimate
and the MMSE weights it feeds, and the payload de-rotation run on a JAX
decode's state.  Same numpy inputs to both packages; each tolerance is
stated beside its check."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from rub_mimo_tpu.config import Detector
from rub_mimo_tpu.detect import weights as jweights
from rub_mimo_tpu.estimate import cfo as jcfo
from rub_mimo_tpu.estimate import ls as jls
from rub_mimo_tpu.estimate import smooth as jsmooth
from rub_mimo_tpu.io import simulator as jsim
from rub_mimo_tpu.sync import matched_filter as jmf
from rub_mimo_tpu.sync import schmidl_cox as jsc
from rub_mimo_tpu.sync import xcorr_sync as jxs
from rub_mimo_tpu.utils import gather as jgather
from rub_mimo_tpu_torch import convert
from rub_mimo_tpu_torch.detect import weights
from rub_mimo_tpu_torch.estimate import cfo, ls, smooth
from rub_mimo_tpu_torch.io import simulator
from rub_mimo_tpu_torch.kernels import payload_fused as pf
from rub_mimo_tpu_torch.ofdm import constellation
from rub_mimo_tpu_torch.pipeline import report, rx
from rub_mimo_tpu_torch.sync import schmidl_cox, xcorr_sync
from rub_mimo_tpu_torch.utils import gather
import torch_oracle as oracle

CFO = 0.05  # subcarrier spacings


@pytest.mark.parametrize("flat", [True, False], ids=["flat", "fir"])
def test_simulator_cfo_matches_jax_noise_free(flat):
    cfg = oracle.TINY
    kw = dict(snr_db=float("inf"), delay=300, seed=3, cfo_subcarriers=CFO,
              flat=flat, num_taps=4)
    ref, _, _ = jsim.simulate_capture(cfg, jsim.ChannelSpec(**kw))
    got, _, _ = simulator.simulate_capture(oracle.pcfg(cfg),
                                           simulator.ChannelSpec(**kw),
                                           device="cpu")
    # exp and the FIR FFTs round differently in each package (|x| <= ~2.2)
    np.testing.assert_allclose(oracle.n(got), np.asarray(ref), rtol=0,
                               atol=2e-6)
    with pytest.raises(ValueError, match="cfg"):
        simulator.apply_channel(got, np.ones((2, 2, 1), np.complex64),
                                simulator.ChannelSpec(cfo_subcarriers=CFO))


def test_correct_cfo_matches_jax():
    rng = np.random.default_rng(5)
    x = (rng.standard_normal((2, 5000))
         + 1j * rng.standard_normal((2, 5000))).astype(np.complex64)
    for eps in (0.0371, -0.42):
        got = schmidl_cox.correct_cfo(oracle.t(x), torch.tensor(
            eps, dtype=torch.float32), 64)
        ref = jsc.correct_cfo(jnp.asarray(x), jnp.float32(eps), 64)
        assert got.dtype == torch.complex64
        # phases up to ~200 rad: float32 exp rounding, |x| ~ 1
        np.testing.assert_allclose(oracle.n(got), np.asarray(ref), rtol=0,
                                   atol=2e-5)


def test_gather_windows_matches_jax():
    rng = np.random.default_rng(6)
    arr = rng.standard_normal((3, 100)).astype(np.float32)
    rows = np.array([0, 2, 1, 2, 0])
    starts = np.array([-5, 0, 37, 98, 200])  # out-of-range starts clamp
    got = gather.gather_windows(oracle.t(arr), oracle.t(rows),
                                oracle.t(starts), 16)
    ref = jgather.gather_windows(jnp.asarray(arr), jnp.asarray(rows),
                                 jnp.asarray(starts), 16)
    np.testing.assert_array_equal(oracle.n(got), np.asarray(ref))


@pytest.fixture(scope="module", params=["tiny", "mid"])
def region_case(request):
    """A CFO capture's estimation region and the JAX matched filter's
    offsets on it (sync from the port, held equal to JAX's elsewhere)."""
    cfg = {"tiny": oracle.TINY, "mid": oracle.MID}[request.param]
    pcfg = oracle.pcfg(cfg)
    cap, _ = oracle.jax_capture(cfg, cfo_subcarriers=CFO, delay=3000)
    sync = schmidl_cox.synchronize(oracle.t(cap), pcfg)
    region = rx._extract_region(oracle.t(cap), int(sync.sync_index), pcfg)
    joint = not cfg.bit_exact
    mf = jmf.search(jnp.asarray(oracle.n(region)), cfg, joint=joint)
    return cfg, cap, region, mf


def test_cfo_estimators_match_jax(region_case):
    cfg, _, region, mf = region_case
    jreg = jnp.asarray(oracle.n(region))
    ac, s0 = oracle.t(mf.ac_index).long(), oracle.t(mf.s0_index).long()
    pcfg = oracle.pcfg(cfg)
    ph = cfo.access_code_peak_phasors(region, ac, pcfg)
    jph = np.asarray(jcfo.access_code_peak_phasors(jreg, mf.ac_index, cfg))
    assert ph.shape == jph.shape
    # M-term dot products in another summation order
    np.testing.assert_allclose(oracle.n(ph), jph, rtol=0,
                               atol=1e-5 * np.abs(jph).max())
    got = cfo.s0_halves_cfo(region, s0, pcfg)
    ref = jcfo.s0_halves_cfo(jreg, mf.s0_index, cfg)
    assert got.dtype == torch.float32
    assert abs(float(got) - float(ref)) < 1e-5
    assert abs(float(got) - CFO) < 0.01  # the halves see the whole CFO
    got = cfo.residual_cfo(region, ac, pcfg)
    ref = jcfo.residual_cfo(jreg, mf.ac_index, cfg)
    assert abs(float(got) - float(ref)) < 1e-5


def _padded_capture():
    """A capture inside long zero stretches: the score's denominator
    floor decides the silent windows."""
    cap, _ = oracle.jax_capture(oracle.TINY, delay=300)
    return np.pad(cap, ((0, 0), (4000, 3000)))


S0_CASES = {
    "cfo": lambda: oracle.jax_capture(oracle.TINY, cfo_subcarriers=CFO)[0],
    "zero_padded": _padded_capture,
    "low_snr": lambda: oracle.jax_capture(oracle.TINY, snr_db=0.0)[0],
    "all_zero": lambda: np.zeros((2, 3000), np.complex64),
}


@pytest.mark.parametrize("case", list(S0_CASES))
def test_s0_xcorr_sync_matches_jax(case):
    cfg = oracle.TINY
    cap = S0_CASES[case]()
    n_pos = cap.shape[-1] - 100
    got = oracle.n(xcorr_sync.normalized_s0_score(oracle.t(cap), oracle.PTINY,
                                                  n_pos))
    ref = np.asarray(jxs.normalized_s0_score(jnp.asarray(cap), cfg, n_pos))
    # scores in [0, 1] from whole-capture FFT correlations: in windows far
    # below the capture's peak energy the FFT round-off of each package
    # dominates |corr|^2, so values are compared where the window holds
    # at least 1e-2 of the largest window energy
    e = np.cumsum(np.pad((np.abs(cap.astype(np.complex128)) ** 2).sum(0),
                         (1, cfg.M)))
    win = (e[cfg.M:] - e[:-cfg.M])[:n_pos]
    strong = win >= 1e-2 * win.max()
    assert strong.sum() > cfg.M or case == "all_zero"
    np.testing.assert_allclose(got[strong], ref[strong], rtol=0, atol=1e-4)
    assert np.all((got >= 0) & (got <= 1 + 1e-4))
    r = xcorr_sync.s0_xcorr_sync(oracle.t(cap), oracle.PTINY)
    jr = jxs.s0_xcorr_sync(jnp.asarray(cap), cfg)
    assert int(r.peak_index) == int(jr.peak_index)
    assert int(r.sync_index) == int(jr.sync_index)
    assert abs(float(r.quality) - float(jr.quality)) < 1e-4
    if case == "all_zero":
        assert float(r.quality) == 0.0
    else:
        assert float(r.quality) > cfg.sync_fallback_threshold


@pytest.mark.parametrize("M", [64, 2048])
def test_smooth_channel_estimate_matches_jax(M):
    cfg = oracle.TINY if M == 64 else oracle.MID
    rng = np.random.default_rng(M)
    G = (rng.standard_normal((M, 2, 2))
         + 1j * rng.standard_normal((M, 2, 2))).astype(np.complex64)
    got = smooth.smooth_channel_estimate(oracle.t(G), oracle.pcfg(cfg))
    ref = jsmooth.smooth_channel_estimate(jnp.asarray(G), cfg)
    assert got.dtype == torch.complex64
    np.testing.assert_allclose(oracle.n(got), np.asarray(ref), rtol=0,
                               atol=1e-5)


def test_noise_var_and_auto_noise_weights_match_jax(region_case):
    cfg, _, region, mf = region_case
    jreg = jnp.asarray(oracle.n(region))
    ac = oracle.t(mf.ac_index).long()
    G = np.asarray(jls.estimate_channel(jreg, mf.ac_index, cfg))
    nv = ls.estimate_noise_var(region, ac, oracle.t(G), oracle.pcfg(cfg))
    jnv = jls.estimate_noise_var(jreg, mf.ac_index, jnp.asarray(G), cfg)
    assert nv.dtype == torch.float32 and float(nv) > 0
    np.testing.assert_allclose(float(nv), float(jnv), rtol=1e-4)
    c = cfg.replace(detector=Detector.MMSE, mmse_auto_noise=True)
    W, g = weights.weights_for(oracle.pcfg(c), oracle.t(G), oracle.t(G),
                               region, ac)
    jW, jg = jweights.weights_for(c, jnp.asarray(G), jnp.asarray(G), jreg,
                                  mf.ac_index)
    np.testing.assert_allclose(oracle.n(W), np.asarray(jW), rtol=1e-4,
                               atol=1e-5)
    np.testing.assert_array_equal(oracle.n(g), np.asarray(jg))
    with pytest.raises(ValueError, match="mmse_auto_noise"):
        weights.weights_for(oracle.pcfg(c), oracle.t(G), oracle.t(G))


@pytest.fixture(scope="module")
def mid_decoded():
    """Every front-end option on at MID, on a CFO capture: the JAX and the
    port decodes."""
    cfg = oracle.MID.replace(correct_cfo=True, sync_fallback=True,
                             smooth_channel=True, detector=Detector.MMSE,
                             mmse_auto_noise=True)
    cap, tx = oracle.jax_capture(cfg, cfo_subcarriers=CFO, delay=3000)
    return cfg, cap, tx, oracle.jax_decode(cap, cfg), rx.make_decoder(
        oracle.pcfg(cfg), device="cpu")(cap)


def test_all_options_decode_matches_jax_at_mid(mid_decoded):
    cfg, _, tx, ref, got = mid_decoded
    oracle.assert_decode_matches_jax(got, ref)
    assert abs(float(got.cfo_hat) - CFO) < 1e-3
    assert report.score(got, tx, oracle.pcfg(cfg)).symbol_error_rate == [
        0.0, 0.0]


def test_payload_derotation_on_jax_state_matches_jax(mid_decoded):
    """The port's coarse and residual de-rotations and the plain payload
    tail, run on a JAX CFO decode's state, give JAX's decisions."""
    cfg, cap, _, r, _ = mid_decoded
    keys = ("W", "normalize_gain", "decode_start", "sync_index", "cfo_hat",
            "cfo_coarse")
    st = convert.from_jax_state({k: np.asarray(getattr(r, k)) for k in keys},
                                "cpu")
    assert st["cfo_hat"].dtype == torch.float32
    iq = schmidl_cox.correct_cfo(oracle.t(cap), st["cfo_coarse"], cfg.M)
    n_sym, sym = cfg.pid_max, cfg.symbol_len
    cstart = (int(st["sync_index"]) + int(st["decode_start"]) - sym)
    payload = rx.derotate_payload(
        rx.extract_payload(iq, cstart, n_sym * sym),
        st["cfo_hat"] - st["cfo_coarse"], st["decode_start"], cfg.M)
    sig, data = pf.payload_tail_reference(
        payload.real.contiguous(), payload.imag.contiguous(), st["W"],
        st["normalize_gain"], constellation.table(
            oracle.pcfg(cfg).modulation),
        np.float32(1.0 / np.sqrt(cfg.M)), n_sym=n_sym, symbol_len=sym,
        cp_len=cfg.cp_len)
    np.testing.assert_array_equal(oracle.n(data).reshape(2, -1),
                                  np.asarray(r.rx_data))
    # the residual is cfo_hat - cfo_coarse here, a sum of two in JAX
    np.testing.assert_allclose(oracle.n(sig).reshape(2, -1),
                               np.asarray(r.rx_sig), rtol=0, atol=1e-4)
