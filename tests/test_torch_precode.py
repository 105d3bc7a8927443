"""Port parity: TX precoding (detect/precode.py) and precoded framing
(ofdm/framegen.transmit_frame(precoder=)).

Tolerances: precoders and effective channels within rtol 1e-5 of the JAX
package's; the precoded TX signal within atol 1e-5; a precoded round
decodes with SER 0.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from rub_mimo_tpu.detect import precode as jprecode
from rub_mimo_tpu.ofdm import framegen as jfg
from rub_mimo_tpu_torch.config import CommMode
from rub_mimo_tpu_torch.detect import precode
from rub_mimo_tpu_torch.io import simulator
from rub_mimo_tpu_torch.ofdm import framegen, sctype
from rub_mimo_tpu_torch.pipeline import report, rx
import torch_oracle as oracle


def _channel(seed: int, n_sc: int, S: int = 2) -> np.ndarray:
    rng = np.random.default_rng(seed)
    return ((rng.standard_normal((n_sc, S, S))
             + 1j * rng.standard_normal((n_sc, S, S))) / np.sqrt(2)
            + 2.0 * np.eye(S)).astype(np.complex64)


@pytest.mark.parametrize("S", [2, 3])
def test_precoders_match_jax(S):
    G = _channel(S, 48, S)
    P = precode.zf_precoder(torch.as_tensor(G))
    jP = np.asarray(jprecode.zf_precoder(jnp.asarray(G)))
    assert P.dtype == torch.complex64
    np.testing.assert_allclose(oracle.n(P), jP, rtol=1e-5, atol=1e-6)
    for nv in (0.01, 0.5):
        Pm = precode.mmse_precoder(torch.as_tensor(G), nv)
        jPm = np.asarray(jprecode.mmse_precoder(jnp.asarray(G), nv))
        np.testing.assert_allclose(oracle.n(Pm), jPm, rtol=1e-5, atol=1e-6)
    E = precode.effective_channel(torch.as_tensor(G), P)
    jE = np.asarray(jprecode.effective_channel(jnp.asarray(G),
                                               jnp.asarray(jP)))
    np.testing.assert_allclose(oracle.n(E), jE, rtol=1e-5, atol=1e-6)
    # normalized: each subcarrier's ||P||_F^2 is the stream count
    np.testing.assert_allclose(oracle.n(torch.sum(P.abs() ** 2, (-2, -1))),
                               S, rtol=1e-5)


@pytest.mark.parametrize("cfg", [oracle.TINY, oracle.TINY.replace(
    use_all_carriers=False)], ids=["all_carriers", "guard_bands"])
def test_precoded_transmit_frame_matches_jax(cfg):
    pcfg = oracle.pcfg(cfg)
    G = _channel(7, sctype.m_occupied(pcfg))
    jP = jprecode.zf_precoder(jnp.asarray(G))
    P = precode.zf_precoder(torch.as_tensor(G))
    tx_data = jfg.generate_payload_symbols(cfg, seed=3)
    ours = oracle.n(framegen.transmit_frame(pcfg, tx_data, device="cpu",
                                            precoder=P))
    ref = np.asarray(jfg.transmit_frame(cfg, jnp.asarray(tx_data),
                                        precoder=jP))
    assert ours.dtype == np.complex64 and ours.shape == ref.shape
    np.testing.assert_allclose(ours, ref, rtol=0, atol=1e-5)
    np.testing.assert_allclose(
        oracle.n(framegen.write_sync_words_precoded(pcfg, P)),
        np.asarray(jfg.write_sync_words_precoded(cfg, jP)), rtol=0,
        atol=1e-5)


def test_precoder_refused_in_alamouti():
    pcfg = oracle.PTINY.replace(mode=CommMode.ALAMOUTI)
    tx_data = framegen.generate_payload_symbols(pcfg)
    with pytest.raises(ValueError, match="ALAMOUTI"):
        framegen.transmit_frame(pcfg, tx_data, device="cpu",
                                precoder=np.ones((pcfg.M, 2, 2),
                                                 np.complex64))


def test_precoded_round_decodes():
    """The closed loop of `cli run --precoded`: decode a first round, ZF
    precode a second through the same channel; it decodes with SER 0 and
    its effective channel is near the identity."""
    cfg = oracle.PTINY.replace(bit_exact=False)
    spec = simulator.ChannelSpec(snr_db=35.0, delay=300, seed=42)
    cap, tx_data, h = simulator.simulate_capture(cfg, spec, device="cpu")
    dec = rx.make_decoder(cfg, device="cpu")
    first = dec(cap)
    assert report.score(first, tx_data, cfg).symbol_error_rate == [0.0, 0.0]
    P = precode.zf_precoder(rx.occupied_channel(first.G, cfg))
    tx2_data = framegen.generate_payload_symbols(cfg, seed=1042)
    cap2 = simulator.apply_channel(
        framegen.transmit_frame(cfg, tx2_data, device="cpu", precoder=P), h,
        spec, cfg)
    second = dec(cap2)
    rep = report.score(second, tx2_data, cfg)
    assert rep.synced and rep.symbol_error_rate == [0.0, 0.0]
    G2 = oracle.n(second.G)
    # G2 ~ c I per subcarrier: off-diagonals small against the diagonal
    off = np.abs(G2[:, 0, 1]) + np.abs(G2[:, 1, 0])
    assert np.median(off / np.abs(G2[:, 0, 0])) < 0.1
