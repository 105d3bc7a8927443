"""Port parity of the SFO chain: rub_mimo_tpu_torch.utils.resample,
estimate.sfo and the simulator's sfo_ppm against the JAX package on the
same numpy inputs (the cases of tests/test_sfo.py and
tests/test_sfo_streaming.py).

Tolerances: resampled signals within rtol 1e-4 of their peak (the FFTs
of the two backends round differently; positions and the cubic's
coefficients are the same float32 operations); the SFO estimates
(estimate_sfo, fit_subcarrier_slope, preamble_sfo) within 1e-7 in delta
(0.1 ppm: float32 moments summed in another order), decode_with_sfo's
delta within 1e-6 and its decisions equal."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from rub_mimo_tpu.config import CommMode, Detector, Modulation, tiny_config
from rub_mimo_tpu.estimate import sfo as jsfo
from rub_mimo_tpu.io import simulator as jsim
from rub_mimo_tpu.ofdm import framegen as jframegen
from rub_mimo_tpu.pipeline import rx as jrx
from rub_mimo_tpu.utils import resample as jres
from rub_mimo_tpu_torch.estimate import sfo
from rub_mimo_tpu_torch.io import simulator
from rub_mimo_tpu_torch.ofdm import framegen
from rub_mimo_tpu_torch.pipeline import rx
from rub_mimo_tpu_torch.utils import resample
import torch_oracle as oracle

SFO_CFG = tiny_config(bit_exact=False, pid_max=16,
                      modulation=Modulation.QAM16, sync_fallback=True)


def assert_close_to_peak(got: torch.Tensor, want, rtol: float = 1e-4):
    want = np.asarray(want)
    err = np.abs(oracle.n(got) - want).max()
    assert err <= rtol * np.abs(want).max(), err


def signal(seed: int, T: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((2, T))
            + 1j * rng.standard_normal((2, T))).astype(np.complex64)


@pytest.mark.parametrize("T", [4096, 4097])
@pytest.mark.parametrize("ppm", [100.0, -37.0])
def test_resamplers_match_jax(T, ppm):
    """Seeded noise (the whole band) through both resamplers, the factor
    as a number and as a float32 tensor; a real signal stays real."""
    x = signal(T, T)
    f = 1.0 + ppm * 1e-6
    for fn, jfn in ((resample.resample_bandlimited,
                     jres.resample_bandlimited),
                    (resample.resample_linear, jres.resample_linear)):
        want = jfn(jnp.asarray(x), f)
        assert_close_to_peak(fn(torch.as_tensor(x), f), want)
        got = fn(torch.as_tensor(x), torch.tensor(f, dtype=torch.float32))
        assert got.dtype == torch.complex64
        assert_close_to_peak(got, want)
        real = fn(torch.as_tensor(x.real.copy()), f)
        assert real.dtype == torch.float32
        assert_close_to_peak(real, jfn(jnp.asarray(x.real), f))


@pytest.mark.parametrize("b", [5, 4097 // 2])
def test_bandlimited_resampler_odd_length_tone(b):
    """tests/test_sfo.py's odd-length case: the top positive bin does not
    alias (amplitude error < 1 % of the exact resampled tone)."""
    T = 4097
    t = np.arange(T)
    f = 1.0 + 100e-6
    x = np.exp(2j * np.pi * (b / T) * t).astype(np.complex64)[None, :]
    y = oracle.n(resample.resample_bandlimited(torch.as_tensor(x), f))
    want = np.exp(2j * np.pi * (b / T) * t * f)
    assert np.abs(y[0, 100:-100] - want[100:-100]).max() < 0.01


def test_streaming_resampler_matches_jax():
    """Chunk by chunk against the JAX StreamingResampler: a takeover at an
    origin with preloaded history, a retune mid-stream, the flush (its
    zero tail included)."""
    T, C = 8192, 512
    t = np.arange(T)
    x = np.stack([np.exp(2j * np.pi * (642 / T) * t),
                  0.5 * np.exp(-2j * np.pi * (2000 / T) * t)]
                 ).astype(np.complex64)
    ours = resample.StreamingResampler(2, C, factor=1 - 100e-6, origin=2048,
                                       device="cpu")
    ref = jres.StreamingResampler(2, C, factor=1 - 100e-6, origin=2048)
    for g in range(1024, 2048, C):
        ours.preload_history(x[:, g:g + C], g)
        ref.preload_history(x[:, g:g + C], g)
    got, want = [], []
    for i, g in enumerate(range(2048, T, C)):
        if i == 5:
            ours.set_factor(1 + 50e-6)
            ref.set_factor(1 + 50e-6)
        a, b = ours.push(torch.as_tensor(x[:, g:g + C])), ref.push(
            x[:, g:g + C])
        assert len(a) == len(b)
        got += a
        want += b
    got += ours.flush()
    want += ref.flush()
    assert len(got) == len(want) and ours._q == ref._q
    out = torch.cat(got, dim=-1)
    ref_out = np.concatenate([np.asarray(w) for w in want], axis=-1)
    assert_close_to_peak(out, ref_out)
    np.testing.assert_array_equal(oracle.n(out) == 0, ref_out == 0)
    with pytest.raises(ValueError):
        ours.push(torch.zeros((2, C + 1), dtype=torch.complex64))


def test_streaming_resampler_has_no_default_device():
    """The ring's device is a required keyword, as at every entry point
    of the port: no silent CPU ring."""
    with pytest.raises(TypeError):
        resample.StreamingResampler(2, 512)
    assert resample.StreamingResampler(2, 512, device="cpu").device == \
        torch.device("cpu")


@pytest.fixture(scope="module")
def sfo_capture():
    """tests/test_sfo.py::test_preamble_sfo_data_aided_tiny's capture
    (120 ppm) with both decodes of it."""
    cap, tx = oracle.jax_capture(SFO_CFG, snr_db=35.0, delay=333, seed=3,
                                 sfo_ppm=120.0)
    jr = jrx.decode(jnp.asarray(cap), SFO_CFG)
    r = rx.make_decoder(oracle.pcfg(SFO_CFG), device="cpu")(cap)
    return cap, tx, jr, r


def test_estimators_match_jax(sfo_capture):
    cap, tx, jr, r = sfo_capture
    cfg = oracle.pcfg(SFO_CFG)
    pairs = [
        (sfo.estimate_sfo(r.rx_sig, cfg, decisions=torch.as_tensor(tx)),
         jsfo.estimate_sfo(jr.rx_sig, SFO_CFG, decisions=jnp.asarray(tx))),
        (sfo.estimate_sfo(r.rx_sig, cfg, n_frames=8),
         jsfo.estimate_sfo(jr.rx_sig, SFO_CFG, n_frames=8)),
        (sfo.preamble_sfo(rx._extract_region(torch.as_tensor(cap),
                                             r.sync_index, cfg),
                          r.ac_index, cfg),
         jsfo.preamble_sfo(jrx._extract_region(jnp.asarray(cap),
                                               jr.sync_index, SFO_CFG),
                           jr.ac_index, SFO_CFG)),
    ]
    for got, want in pairs:
        assert got.dtype == torch.float32 and got.dim() == 0
        assert abs(float(got) - float(want)) < 1e-7, (float(got), float(want))
    # the data-aided estimate finds the offset with no decisions at all
    assert abs(float(pairs[2][0]) * 1e6 - 120.0) < 25.0


@pytest.mark.parametrize("guard_bands", [False, True])
def test_fit_subcarrier_slope_matches_jax(guard_bands):
    """Seeded moments with a planted slope, all carriers and with guard
    bands (the Nyquist bin left out where it is occupied)."""
    jcfg = tiny_config(use_all_carriers=not guard_bands)
    cfg = oracle.pcfg(jcfg)
    rng = np.random.default_rng(4)
    m = cfg.M_occupied
    z = ((1.0 + rng.random(m)) * np.exp(1j * (0.3 + 0.01 * rng.standard_normal(
        m) + 0.02 * np.arange(m)))).astype(np.complex64)
    got = sfo.fit_subcarrier_slope(torch.as_tensor(z), cfg)
    want = jsfo.fit_subcarrier_slope(jnp.asarray(z), jcfg)
    assert abs(float(got) - float(want)) < 1e-7
    zero = sfo.fit_subcarrier_slope(torch.zeros(m, dtype=torch.complex64),
                                    cfg)
    assert float(zero) == float(jsfo.fit_subcarrier_slope(
        jnp.zeros(m, jnp.complex64), jcfg)) == 0.0


def test_correct_sfo_matches_jax(sfo_capture):
    cap = sfo_capture[0]
    d = np.float32(-119e-6)
    want = jsfo.correct_sfo(jnp.asarray(cap), d)
    assert_close_to_peak(sfo.correct_sfo(torch.as_tensor(cap), float(d)),
                         want)
    assert_close_to_peak(sfo.correct_sfo(torch.as_tensor(cap),
                                         torch.tensor(d)), want)


@pytest.mark.parametrize("detector", ["zf", "ml"])
def test_decode_with_sfo_matches_jax(detector, sfo_capture):
    """The two-pass flow on the 120 ppm capture: delta within 1e-6 of
    JAX's, the final decisions equal, the SER low; an ML final decode
    runs its helper decodes with ZF, as JAX does."""
    cap, tx = sfo_capture[:2]
    jcfg = SFO_CFG.replace(detector=Detector(detector))
    cfg = oracle.pcfg(jcfg)
    jr, jd, jiq = jsfo.decode_with_sfo(jnp.asarray(cap), jcfg, iters=2)
    r, d, iq = sfo.decode_with_sfo(cap, cfg, device="cpu", iters=2)
    assert d.dtype == torch.float32
    assert abs(float(d) - float(jd)) < 1e-6, (float(d), float(jd))
    np.testing.assert_array_equal(oracle.n(r.rx_data), np.asarray(jr.rx_data))
    assert_close_to_peak(iq, jiq)
    n = cfg.pid_max * cfg.M_occupied
    assert (oracle.n(r.rx_data)[:, :n] != tx[:, :n]).mean() < 0.01
    assert abs(float(d) * 1e6 - 120.0) < 0.15 * 120.0 + 5.0


def test_decode_with_sfo_refuses_single_stream_modes():
    for mode in (CommMode.SISO, CommMode.ALAMOUTI, CommMode.RX_DIVERSITY):
        cfg = oracle.pcfg(tiny_config(mode=mode))
        with pytest.raises(ValueError, match="ZF-family"):
            sfo.decode_with_sfo(np.zeros((2, 4096), np.complex64), cfg,
                                device="cpu")


def test_simulator_sfo_matches_jax():
    """The port's channel with sfo_ppm against JAX's on the same TX frame,
    noise-free: resampled after the CFO rotation, before the delay."""
    cfg = oracle.pcfg(SFO_CFG)
    tx_data = framegen.generate_payload_symbols(cfg, seed=1)
    kw = dict(snr_db=float("inf"), delay=333, seed=3, sfo_ppm=80.0,
              cfo_subcarriers=0.02)
    h = simulator.draw_channel(simulator.ChannelSpec(**kw), 2, 2)
    got = simulator.apply_channel(
        framegen.transmit_frame(cfg, tx_data, device="cpu"), h,
        simulator.ChannelSpec(**kw), cfg)
    want = jsim.apply_channel(
        jframegen.transmit_frame(SFO_CFG, jnp.asarray(tx_data)), h,
        jsim.ChannelSpec(**kw), SFO_CFG)
    assert got.shape == tuple(want.shape)
    np.testing.assert_array_equal(oracle.n(got)[:, :333], 0)
    assert_close_to_peak(got, want)
