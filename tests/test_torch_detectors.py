"""Port parity of the detectors and modes of the generic payload tail: the
SISO, diversity and Alamouti combiners, SIC, ML, channel tracking, the
postprocess and the equalizer dispatch against the JAX package's on the
same numpy inputs; the TX side of the new modes; and whole decodes of
each mode and detector, and of the small presets, against the JAX decode
of the same capture (tests/torch_oracle.py::assert_decode_matches_jax
states the tolerances)."""

import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from rub_mimo_tpu.config import CommMode, Detector, Modulation
from rub_mimo_tpu.detect import alamouti as jalamouti
from rub_mimo_tpu.detect import diversity as jdiversity
from rub_mimo_tpu.detect import dispatch as jdispatch
from rub_mimo_tpu.detect import ml as jml
from rub_mimo_tpu.detect import postprocess as jpostprocess
from rub_mimo_tpu.detect import sic as jsic
from rub_mimo_tpu.detect import siso as jsiso
from rub_mimo_tpu.detect import tracking as jtracking
from rub_mimo_tpu.detect import zf as jzf
from rub_mimo_tpu.models import presets as jpresets
from rub_mimo_tpu.ofdm import framegen as jfg
from rub_mimo_tpu.pipeline import report as jreport
from rub_mimo_tpu_torch.detect import (alamouti, diversity, dispatch, ml,
                                       postprocess, sic, siso, tracking)
from rub_mimo_tpu_torch.kernels import eq_demap as k34
from rub_mimo_tpu_torch.models import presets
from rub_mimo_tpu_torch.ofdm import framegen
from rub_mimo_tpu_torch.pipeline import report, rx
import torch_oracle as oracle

RTOL, ATOL = 1e-4, 1e-5  # float32 rounding in another operation order
TINY = oracle.TINY.replace(bit_exact=False)


def _complex(rng, shape):
    return (rng.standard_normal(shape)
            + 1j * rng.standard_normal(shape)).astype(np.complex64)


def _channel(rng, n_sc, S, dominance=2.0):
    """A well-conditioned channel [n_sc, S, S] (distinct SIC errors)."""
    return (_complex(rng, (n_sc, S, S)) / np.sqrt(2)
            + dominance * np.eye(S)).astype(np.complex64)


def _close(got, ref, rtol=RTOL, atol=ATOL):
    np.testing.assert_allclose(oracle.n(got), np.asarray(ref), rtol=rtol,
                               atol=atol)


def test_siso_and_mrc_match_jax():
    rng = np.random.default_rng(1)
    Y, G = _complex(rng, (5, 2, 64)), _channel(rng, 64, 2)
    for rx_s, tx_s in ((0, 0), (1, 0), (1, 1)):
        _close(siso.siso_equalize(oracle.t(Y), oracle.t(G), rx_s, tx_s),
               jsiso.siso_equalize(jnp.asarray(Y), jnp.asarray(G), rx_s,
                                   tx_s))
        _close(diversity.mrc_combine(oracle.t(Y), oracle.t(G), tx_s),
               jdiversity.mrc_combine(jnp.asarray(Y), jnp.asarray(G), tx_s))


def test_alamouti_pairs_match_jax():
    rng = np.random.default_rng(2)
    sym = _complex(rng, (6, 64))
    np.testing.assert_array_equal(
        oracle.n(alamouti.encode_pairs(oracle.t(sym))),
        np.asarray(jalamouti.encode_pairs(jnp.asarray(sym))))
    Y, G = _complex(rng, (6, 2, 64)), _channel(rng, 64, 2)
    _close(alamouti.combine_pairs(oracle.t(Y), oracle.t(G)),
           jalamouti.combine_pairs(jnp.asarray(Y), jnp.asarray(G)))


def _noisy_grid(rng, G, mod, n_sym=6, noise=0.02):
    """Y [n_sym, rx, n_sc] = G s + noise for random symbols of ``mod``."""
    from rub_mimo_tpu.ofdm import constellation as jconst

    table = jconst.table(mod)
    n_sc, _, S = G.shape
    s = table[rng.integers(0, len(table), (n_sym, S, n_sc))]
    Y = np.einsum("krt,ntk->nrk", G, s) + noise * _complex(
        rng, (n_sym, S, n_sc))
    return Y.astype(np.complex64)


@pytest.mark.parametrize("S", [2, 3])
def test_sic_matches_jax(S):
    rng = np.random.default_rng(S)
    G = _channel(rng, 64, S)
    cfg = TINY.replace(num_streams=S, detector=Detector.SIC,
                       modulation=Modulation.QAM16)
    Y = _noisy_grid(rng, G, cfg.modulation)
    got = sic.sic_equalize(oracle.t(Y), oracle.t(G), oracle.pcfg(cfg), 1e-3)
    ref = jsic.sic_equalize(jnp.asarray(Y), jnp.asarray(G), cfg, 1e-3)
    _close(got, ref)


@pytest.mark.parametrize("mod", [Modulation.QPSK, Modulation.QAM16])
def test_ml_matches_jax(mod):
    rng = np.random.default_rng(5)
    G = _channel(rng, 64, 2, dominance=1.0)
    cfg = TINY.replace(detector=Detector.ML, modulation=mod)
    Y = _noisy_grid(rng, G, mod, n_sym=20, noise=0.1)  # two ML blocks
    got = ml.ml_detect(oracle.t(Y), oracle.t(G), oracle.pcfg(cfg))
    ref = jml.ml_detect(jnp.asarray(Y), jnp.asarray(G), cfg)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(oracle.n(got), np.asarray(ref))
    _close(ml.ml_equalize(oracle.t(Y), oracle.t(G), oracle.pcfg(cfg)),
           jml.ml_equalize(jnp.asarray(Y), jnp.asarray(G), cfg))


def test_tracking_matches_jax():
    rng = np.random.default_rng(6)
    G = _channel(rng, 64, 2)
    cfg = TINY
    Y = _noisy_grid(rng, G, cfg.modulation, n_sym=8)
    G0 = (G + 0.05 * _complex(rng, G.shape)).astype(np.complex64)
    before = k34.demap.launches
    eq, G_last = tracking.track_and_equalize(
        oracle.t(Y), oracle.t(G0), oracle.pcfg(cfg), block_frames=4,
        alpha=0.5)
    assert k34.demap.launches == before  # CPU: the plain demap
    jeq, jG = jtracking.track_and_equalize(
        jnp.asarray(Y), jnp.asarray(G0), cfg, block_frames=4, alpha=0.5)
    _close(eq, jeq)
    # two LS refits, each through a matrix inverse, summed in another
    # order: a few float32 ulps of the inverse grow to ~1e-4 relative
    _close(G_last, jG, rtol=1e-3, atol=1e-4)
    with pytest.raises(ValueError, match="block_frames"):
        tracking.track_and_equalize(oracle.t(Y), oracle.t(G0),
                                    oracle.pcfg(cfg), block_frames=3)


@pytest.mark.parametrize("change", [
    dict(use_all_carriers=False, normalize_rx_scale=True),
    dict(track_phase=True),
    dict(track_phase=True, use_all_carriers=False, normalize_rx_scale=True,
         modulation=Modulation.QAM16)],
    ids=["normalize", "track_phase", "both"])
def test_postprocess_matches_jax(change):
    rng = np.random.default_rng(7)
    cfg = TINY.replace(**change)
    eq = (_complex(rng, (4, 2, cfg.M_occupied)) * 0.1
          + np.exp(0.3j)).astype(np.complex64)
    _close(postprocess.postprocess_eq(oracle.t(eq), oracle.pcfg(cfg)),
           jpostprocess.postprocess_eq(jnp.asarray(eq), cfg))


@pytest.mark.parametrize("change", [
    dict(), dict(detector=Detector.MMSE),
    dict(mode=CommMode.SISO), dict(mode=CommMode.RX_DIVERSITY),
    dict(detector=Detector.ML), dict(detector=Detector.SIC),
    dict(mode=CommMode.RX_BEAMFORMING)],
    ids=["zf", "mmse", "siso", "diversity", "ml", "sic", "rx_bf"])
def test_equalize_dispatch_matches_jax(change):
    rng = np.random.default_rng(8)
    cfg = TINY.replace(**change)
    G = _channel(rng, 64, 2)
    Y = _noisy_grid(rng, G, cfg.modulation)
    W, gain = jzf.invert(jnp.asarray(G))
    got = dispatch.equalize_dispatch(oracle.t(Y), oracle.t(G),
                                     oracle.t(W), oracle.t(gain),
                                     oracle.pcfg(cfg))
    ref = jdispatch.equalize_dispatch(jnp.asarray(Y), jnp.asarray(G), W,
                                      gain, cfg)
    _close(got, ref)


@pytest.mark.parametrize("change", [
    dict(mode=CommMode.SISO), dict(mode=CommMode.RX_DIVERSITY, siso_tx=0),
    dict(mode=CommMode.ALAMOUTI)], ids=["siso", "diversity", "alamouti"])
def test_transmit_frame_modes_match_jax(change):
    cfg = TINY.replace(**change)
    tx_data = jfg.generate_payload_symbols(cfg, seed=3)
    np.testing.assert_array_equal(
        framegen.generate_payload_symbols(oracle.pcfg(cfg), 3), tx_data)
    ours = oracle.n(framegen.transmit_frame(oracle.pcfg(cfg), tx_data,
                                            device="cpu"))
    ref = np.asarray(jfg.transmit_frame(cfg, jnp.asarray(tx_data)))
    assert ours.shape == ref.shape
    assert np.abs(ours - ref).max() < 1e-5 * np.abs(ref).max()


# (JAX config, capture options): each mode and detector at TINY
MODE_CASES = {
    "siso": (TINY.replace(num_streams=1, mode=CommMode.SISO, siso_tx=0,
                          siso_rx=0), dict(identity=True)),
    "rx_diversity": (TINY.replace(mode=CommMode.RX_DIVERSITY,
                                  modulation=Modulation.QAM16), dict()),
    "alamouti": (TINY.replace(mode=CommMode.ALAMOUTI), dict()),
    "sic": (TINY.replace(detector=Detector.SIC,
                         modulation=Modulation.QAM16), dict(seed=3)),
    "ml": (TINY.replace(detector=Detector.ML), dict()),
    "track_channel": (TINY.replace(track_channel=True,
                                   track_block_frames=4), dict()),
    "track_phase": (TINY.replace(track_phase=True), dict()),
    "rx_beamforming": (TINY.replace(mode=CommMode.RX_BEAMFORMING), dict()),
    "siso_loopback": (jpresets.siso_loopback(
        num_subcarriers=64, cp_len=16, num_access_codes=4, pid_max=6)[0],
        dict(identity=True, snr_db=25.0)),
    "wifi_like": (jpresets.wifi_like(pid_max=20)[0],
                  dict(snr_db=22.0, delay=777, cfo_subcarriers=0.03,
                       flat=False, num_taps=3, seed=7)),
}


@pytest.mark.parametrize("case", list(MODE_CASES))
def test_mode_decodes_match_jax(case):
    cfg, cap_kw = MODE_CASES[case]
    cap, tx = oracle.jax_capture(cfg, **cap_kw)
    ref = oracle.jax_decode(cap, cfg)
    got = rx.make_decoder(oracle.pcfg(cfg), device="cpu")(cap)
    assert bool(ref.synced)
    oracle.assert_decode_matches_jax(got, ref)
    np.testing.assert_allclose(oracle.n(got.rx_sig), np.asarray(ref.rx_sig),
                               rtol=RTOL, atol=1e-4 if cfg.correct_cfo
                               else ATOL)
    assert (got.Y is None) == (ref.Y is None)
    if ref.Y is not None:
        _close(got.Y, ref.Y)
    ours = report.score(got, tx, oracle.pcfg(cfg))
    theirs = jreport.score(ref, tx, cfg)
    assert ours.symbol_error_rate == theirs.symbol_error_rate
    assert ours.symbols_transmitted == theirs.symbols_transmitted
    if case != "wifi_like":  # uncoded 16-QAM at 22 dB: pairs with FEC
        assert ours.symbol_error_rate == [0.0] * len(ours.symbol_error_rate)


def test_port_presets_decode_on_cpu():
    """The port's own presets, made and decoded by the port alone."""
    from rub_mimo_tpu_torch.io import simulator

    for name in ("siso_loopback", "mimo_2x2_zf"):
        cfg, spec = presets.get(name, num_subcarriers=64, cp_len=16,
                                num_access_codes=4, pid_max=6)
        cap, tx, _ = simulator.simulate_capture(
            cfg, dataclasses.replace(spec, delay=300), device="cpu")
        r = rx.make_decoder(cfg, device="cpu")(cap)
        rep = report.score(r, tx, cfg)
        assert rep.synced and rep.symbol_error_rate == [0.0] * len(
            rep.symbol_error_rate), name


@pytest.mark.parametrize("N", [2, 3, 4])
def test_weights_are_contiguous(N):
    """The CUDA payload kernels take W as contiguous [M, N, N] rows; the
    torch.linalg paths of N > 2 return other strides."""
    from rub_mimo_tpu_torch.detect import mmse, zf

    rng = np.random.default_rng(N)
    G = oracle.t(_channel(rng, 16, N))
    for W, _ in (zf.invert(G), zf.invert(G, True), mmse.mmse_weights(G, 0.1)):
        assert W.is_contiguous() and W.shape == (16, N, N)
