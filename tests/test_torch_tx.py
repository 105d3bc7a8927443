"""Port parity: TX framing and the channel simulator.  The noise-free
signals match the JAX package within 1e-5 relative; the channel draw and
the payload symbols are equal; the port's AWGN is seeded and has the
requested power."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from rub_mimo_tpu.config import CommMode
from rub_mimo_tpu.io import simulator as jsim
from rub_mimo_tpu.ofdm import framegen as jfg
from rub_mimo_tpu_torch.io import simulator
from rub_mimo_tpu_torch.ofdm import framegen
import torch_oracle as oracle

CFGS = [oracle.TINY, oracle.MID]
IDS = ["tiny", "mid"]


def _rel(a, b):
    return np.abs(a - b).max() / np.abs(b).max()


@pytest.mark.parametrize("cfg", CFGS, ids=IDS)
def test_sync_words_and_payload_symbols_equal(cfg):
    pcfg = oracle.pcfg(cfg)
    np.testing.assert_array_equal(framegen.write_sync_words(pcfg),
                                  jfg.write_sync_words(cfg))
    np.testing.assert_array_equal(framegen.generate_payload_symbols(pcfg, 5),
                                  jfg.generate_payload_symbols(cfg, 5))


@pytest.mark.parametrize("cfg", CFGS, ids=IDS)
def test_transmit_frame_matches_jax(cfg):
    tx_data = jfg.generate_payload_symbols(cfg, seed=2)
    ours = oracle.n(framegen.transmit_frame(oracle.pcfg(cfg), tx_data,
                                            device="cpu"))
    ref = np.asarray(jfg.transmit_frame(cfg, jnp.asarray(tx_data)))
    assert ours.shape == ref.shape and ours.dtype == np.complex64
    assert _rel(ours, ref) < 1e-5


def test_transmit_frame_rejects_unported_modes():
    """Every mode transmits now, precoded TX too (here a SISO frame with
    a precoder, equal to the JAX package's within 1e-5 relative); a JAX
    package config is refused."""
    cfg = oracle.TINY.replace(mode=CommMode.SISO)
    tx_data = jfg.generate_payload_symbols(cfg)
    precoder = np.ones((cfg.M, 2, 2), np.complex64)
    ours = oracle.n(framegen.transmit_frame(oracle.pcfg(cfg), tx_data,
                                            device="cpu",
                                            precoder=precoder))
    ref = np.asarray(jfg.transmit_frame(cfg, jnp.asarray(tx_data),
                                        precoder=jnp.asarray(precoder)))
    assert _rel(ours, ref) < 1e-5
    with pytest.raises(TypeError, match="config_from_jax"):
        framegen.transmit_frame(cfg, tx_data, device="cpu")


@pytest.mark.parametrize("kw", [dict(), dict(flat=False, num_taps=5),
                                dict(identity=True)],
                         ids=["flat", "fir", "identity"])
def test_draw_channel_equal(kw):
    spec = simulator.ChannelSpec(seed=21, **kw)
    jspec = jsim.ChannelSpec(seed=21, **kw)
    np.testing.assert_array_equal(simulator.draw_channel(spec, 2, 2),
                                  jsim.draw_channel(jspec, 2, 2))


@pytest.mark.parametrize("kw", [dict(), dict(flat=False, num_taps=4)],
                         ids=["flat", "fir"])
def test_apply_channel_noise_free_matches_jax(kw):
    cfg = oracle.TINY
    tx_data = jfg.generate_payload_symbols(cfg, seed=4)
    tx = np.asarray(jfg.transmit_frame(cfg, jnp.asarray(tx_data)))
    common = dict(snr_db=float("inf"), delay=37, trailing=55, seed=9, **kw)
    spec, jspec = simulator.ChannelSpec(**common), jsim.ChannelSpec(**common)
    h = simulator.draw_channel(spec, 2, 2)
    ours = oracle.n(simulator.apply_channel(oracle.t(tx), h, spec))
    ref = np.asarray(jsim.apply_channel(jnp.asarray(tx), h, jspec, cfg))
    assert ours.shape == ref.shape
    assert _rel(ours, ref) < 1e-5


def test_simulate_capture_noise_is_seeded_at_the_requested_snr():
    cfg = oracle.PTINY
    spec = simulator.ChannelSpec(snr_db=20.0, delay=100, seed=5)
    a, tx_data, h = simulator.simulate_capture(cfg, spec, device="cpu")
    b, _, _ = simulator.simulate_capture(cfg, spec, device="cpu")
    assert torch.equal(a, b)
    clean = simulator.apply_channel(
        framegen.transmit_frame(cfg, tx_data, device="cpu"), h,
        simulator.ChannelSpec(snr_db=float("inf"), delay=100, seed=5))
    tx = framegen.transmit_frame(cfg, tx_data, device="cpu")
    noise_p = float(torch.mean((a - clean).abs() ** 2))
    sig_p = float(torch.mean(tx.abs() ** 2))
    assert abs(10 * np.log10(sig_p / noise_p) - 20.0) < 0.3
