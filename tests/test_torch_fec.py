"""Port parity of the coded chain: rub_mimo_tpu_torch.ofdm.fec, the soft
LLRs (constellation.soft_demodulate_llr, detect.ml.ml_soft_llrs) and the
Viterbi (kernels.viterbi's plain version on the CPU) against the JAX
package on the same numpy inputs.

Tolerances: every integer and bit exactly equal (encoder, puncturing,
interleaver, packing, encode_payload, encode_data, decode_data, the
Viterbi in both modes, ties and pads included: each step of the
recursion is one correctly rounded add, so the two agree bit for bit);
the LLRs within rtol 1e-5 and an atol of 1e-5 of their largest magnitude
(an LLR is the difference of two metrics, |y - c|^2 rounded by another
hypot on each backend, or for the joint ML LLRs |y|^2 - 2 Re(y^H G c) +
|G c|^2 summed in another order, so a small LLR carries the rounding of
the large metrics it is the difference of); decoded message bits
equal."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from rub_mimo_tpu.config import CommMode, Detector, Modulation, tiny_config
from rub_mimo_tpu.detect import ml as jml
from rub_mimo_tpu.ofdm import constellation as jconst
from rub_mimo_tpu.ofdm import fec as jfec
from rub_mimo_tpu.pipeline import rx as jrx
from rub_mimo_tpu_torch.config import Modulation as PModulation
from rub_mimo_tpu_torch.detect import ml as pml
from rub_mimo_tpu_torch.kernels import soft_llr as ksoft_llr
from rub_mimo_tpu_torch.kernels import viterbi as kviterbi
from rub_mimo_tpu_torch.ofdm import constellation as pconst
from rub_mimo_tpu_torch.ofdm import fec
from rub_mimo_tpu_torch.pipeline import rx
import torch_oracle as oracle

RATES = ("1/2", "2/3", "3/4")
MODS = ("bpsk", "qpsk", "qam16", "arb32opt", "qam64")


def jn(x) -> np.ndarray:
    return np.asarray(x)


def noisy_llrs(seed: int, shape, scale: float = 0.8) -> np.ndarray:
    """BPSK-like LLRs of a random codeword with seeded noise, float32."""
    rng = np.random.default_rng(seed)
    bits = rng.integers(0, 2, size=shape[:-1] + (shape[-1] // 2 - 6,))
    coded = jn(jfec.conv_encode(jnp.asarray(bits.astype(np.int32))))
    llr = (1.0 - 2.0 * coded) + rng.normal(scale=scale, size=coded.shape)
    return (2.0 * llr).astype(np.float32)


@pytest.mark.parametrize("shape", [(7,), (2, 40), (3, 2, 129)])
def test_conv_encode_matches_jax(shape):
    bits = np.random.default_rng(sum(shape)).integers(0, 2, size=shape)
    want = jn(jfec.conv_encode(jnp.asarray(bits.astype(np.int32))))
    got = fec.conv_encode(torch.as_tensor(bits))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(oracle.n(got), want)


@pytest.mark.parametrize("rate", RATES)
def test_puncture_and_depuncture_match_jax(rate):
    rng = np.random.default_rng(5)
    for L in (24, 97, 1000):
        coded = rng.integers(0, 2, size=(2, L)).astype(np.int32)
        kept = jn(jfec.puncture(jnp.asarray(coded), rate))
        np.testing.assert_array_equal(
            oracle.n(fec.puncture(torch.as_tensor(coded), rate)), kept)
        assert fec._kept_bits(L, rate) == jfec._kept_bits(L, rate)
        llr = rng.standard_normal((2, kept.shape[-1] + 3)).astype(np.float32)
        np.testing.assert_array_equal(
            oracle.n(fec.depuncture_llrs(torch.as_tensor(llr), L, rate)),
            jn(jfec.depuncture_llrs(jnp.asarray(llr), L, rate)))


@pytest.mark.parametrize("n", [128, 255, 1001, 3840])
def test_interleaver_matches_jax(n):
    x = np.random.default_rng(n).standard_normal((2, n)).astype(np.float32)
    for spread in (1, 127):
        np.testing.assert_array_equal(
            fec._interleave_perm(n, spread), jfec._interleave_perm(n, spread))
        y = fec.interleave(torch.as_tensor(x), spread)
        np.testing.assert_array_equal(
            oracle.n(y), jn(jfec.interleave(jnp.asarray(x), spread)))
        np.testing.assert_array_equal(
            oracle.n(fec.deinterleave(y, spread)),
            jn(jfec.deinterleave(jfec.interleave(jnp.asarray(x), spread),
                                 spread)))
        np.testing.assert_array_equal(oracle.n(fec.deinterleave(y, spread)),
                                      x)


@pytest.mark.parametrize("mod", MODS)
def test_bit_symbol_packing_matches_jax(mod):
    jm, pm = Modulation(mod), PModulation(mod)
    b = jm.bits_per_symbol
    bits = np.random.default_rng(b).integers(0, 2, size=(2, 60 * b))
    syms = np.array(jfec.bits_to_symbols(jnp.asarray(bits.astype(np.int32)),
                                         jm))
    got = fec.bits_to_symbols(torch.as_tensor(bits), pm)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(oracle.n(got), syms)
    np.testing.assert_array_equal(
        oracle.n(fec.symbols_to_bits(torch.as_tensor(syms), pm)),
        jn(jfec.symbols_to_bits(jnp.asarray(syms), jm)))


@pytest.mark.parametrize("rate", RATES)
@pytest.mark.parametrize("mode", ["rx_zf", "siso", "alamouti"])
def test_encode_payload_matches_jax(rate, mode):
    jcfg = tiny_config(mode=CommMode(mode), pid_max=6,
                       modulation=Modulation.QAM16)
    cfg = oracle.pcfg(jcfg)
    for inter in (True, False):
        msg, tx = fec.encode_payload(cfg, seed=4, interleave_bits=inter,
                                     rate=rate)
        jmsg, jtx = jfec.encode_payload(jcfg, seed=4, interleave_bits=inter,
                                        rate=rate)
        assert isinstance(msg, np.ndarray) and isinstance(tx, np.ndarray)
        np.testing.assert_array_equal(msg, jn(jmsg))
        np.testing.assert_array_equal(tx, jn(jtx))
        assert tx.dtype == np.int32
    assert (fec.message_bits_per_stream(cfg, rate)
            == jfec.message_bits_per_stream(jcfg, rate))
    assert (fec.data_capacity_bytes(cfg, rate)
            == jfec.data_capacity_bytes(jcfg, rate))


@pytest.mark.parametrize("rate", RATES)
def test_encode_and_decode_data_match_jax(rate):
    jcfg = tiny_config(pid_max=8, modulation=Modulation.QAM16)
    cfg = oracle.pcfg(jcfg)
    cap = fec.data_capacity_bytes(cfg, rate)
    data = np.random.default_rng(9).integers(0, 256, size=cap,
                                             dtype=np.uint8).tobytes()
    tx = fec.encode_data(data, cfg, rate=rate)
    np.testing.assert_array_equal(tx, jn(jfec.encode_data(data, jcfg,
                                                          rate=rate)))
    # noiseless equalized symbols of tx: both decoders return the data
    sig = pconst.table(cfg.modulation)[tx]
    got, ok = fec.decode_data(torch.as_tensor(sig), cfg, rate=rate)
    want, jok = jfec.decode_data(jnp.asarray(sig), jcfg, rate=rate)
    assert ok and jok and got == want == data
    # garbage: both refuse the same way
    junk = np.random.default_rng(1).standard_normal(sig.shape).astype(
        np.float32) + 0j
    assert (fec.decode_data(torch.as_tensor(junk.astype(np.complex64)), cfg,
                            rate=rate)
            == jfec.decode_data(jnp.asarray(junk.astype(np.complex64)), jcfg,
                                rate=rate))


def test_encode_data_refusals():
    for jcfg in (tiny_config(pid_max=1, mode=CommMode.SISO),
                 tiny_config(pid_max=2)):
        cfg = oracle.pcfg(jcfg)
        assert fec.data_capacity_bytes(cfg) == jfec.data_capacity_bytes(jcfg)
        too_long = b"x" * (fec.data_capacity_bytes(cfg) + 1)
        with pytest.raises(ValueError):
            fec.encode_data(too_long, cfg)
        with pytest.raises(ValueError):
            jfec.encode_data(too_long, jcfg)


@pytest.mark.parametrize("window", [None, 64])
def test_viterbi_decode_matches_jax(window):
    """Bits equal on noisy codewords, all-zero LLRs (every comparison a
    tie) and LLRs at the +-1e4 pad level, whole codeword or windows of 64
    with 32 steps of margin."""
    kw = {} if window is None else dict(window=window, margin=32)
    llr = noisy_llrs(11, (2, 612))
    llr[0, 40:80] = 0.0                   # erasures: exact ties
    llr[1, 100:140] = 1e4                 # pad-level certainty
    llr[1, 140:150] = -1e4
    cases = [llr, np.zeros((3, 300), np.float32), noisy_llrs(2, (1, 2, 140))]
    for x in cases:
        want = jn(jfec.viterbi_decode(jnp.asarray(x), **kw))
        got = fec.viterbi_decode(torch.as_tensor(x), **kw)
        assert got.dtype == torch.int32 and got.shape == want.shape
        np.testing.assert_array_equal(oracle.n(got), want)


def test_viterbi_plain_refuses_and_counts_nothing_on_cpu():
    pairs = torch.zeros((2, 5, 2))
    before = kviterbi.viterbi.launches
    kviterbi.viterbi(pairs, torch.zeros(2, dtype=torch.bool))
    assert kviterbi.viterbi.launches == before
    with pytest.raises(ValueError):
        kviterbi.viterbi(pairs.double(), torch.zeros(2, dtype=torch.bool))
    with pytest.raises(ValueError):
        kviterbi.viterbi(pairs, torch.zeros(3, dtype=torch.bool))


def test_decode_from_llrs_windowed_matches_jax():
    """A codeword past 4 x 4096 steps takes the windowed decode (window
    4096, margin 128) in both packages: equal bits."""
    jcfg = tiny_config(pid_max=260, modulation=Modulation.QPSK)
    cfg = oracle.pcfg(jcfg)
    n_msg = fec.message_bits_per_stream(cfg)
    assert n_msg + fec.TAIL > 4 * 4096
    n_coded = cfg.pid_max * cfg.M_occupied * 2
    rng = np.random.default_rng(3)
    llr = (rng.standard_normal((2, n_coded)) * 3.0).astype(np.float32)
    want = jn(jfec._decode_from_llrs(jnp.asarray(llr), jcfg, True))
    got = fec._decode_from_llrs(torch.as_tensor(llr), cfg, True)
    np.testing.assert_array_equal(oracle.n(got), want)


@pytest.mark.parametrize("mod", MODS)
def test_soft_demodulate_llr_matches_jax(mod, monkeypatch):
    """Seeded symbols near the constellation; noise_var as a number and
    as a tensor; passes of 37 symbols (a ragged last pass) equal one."""
    rng = np.random.default_rng(len(mod))
    y = (rng.standard_normal((2, 3, 50)) + 1j * rng.standard_normal(
        (2, 3, 50))).astype(np.complex64)
    for nv in (1.0, 0.37):
        want = jn(jconst.soft_demodulate_llr(jnp.asarray(y), Modulation(mod),
                                             nv))
        got = pconst.soft_demodulate_llr(torch.as_tensor(y), PModulation(mod),
                                         nv)
        assert got.dtype == torch.float32 and got.shape == want.shape
        np.testing.assert_allclose(oracle.n(got), want, rtol=1e-5,
                                   atol=1e-5 * np.abs(want).max())
        monkeypatch.setattr(ksoft_llr, "LLR_CHUNK", 37)
        chunked = pconst.soft_demodulate_llr(
            torch.as_tensor(y), PModulation(mod), torch.tensor(nv))
        monkeypatch.undo()
        np.testing.assert_array_equal(oracle.n(chunked), oracle.n(got))


@pytest.mark.parametrize("mod,n_tx", [("bpsk", 2), ("qpsk", 2),
                                      ("qam16", 2), ("qpsk", 3)])
def test_ml_soft_llrs_matches_jax(mod, n_tx):
    rng = np.random.default_rng(n_tx * 10 + len(mod))
    n_sym, n_sc = 19, 24  # 19: a ragged last block of 16
    Y = (rng.standard_normal((n_sym, n_tx, n_sc))
         + 1j * rng.standard_normal((n_sym, n_tx, n_sc))).astype(np.complex64)
    G = ((rng.standard_normal((n_sc, n_tx, n_tx))
          + 1j * rng.standard_normal((n_sc, n_tx, n_tx))) / np.sqrt(2)
         + np.eye(n_tx)).astype(np.complex64)
    jcfg = tiny_config(modulation=Modulation(mod), num_streams=n_tx)
    want = jn(jml.ml_soft_llrs(jnp.asarray(Y), jnp.asarray(G), jcfg, 0.5))
    got = pml.ml_soft_llrs(torch.as_tensor(Y), torch.as_tensor(G),
                           oracle.pcfg(jcfg), 0.5)
    assert got.shape == want.shape == (n_sym, n_tx, n_sc,
                                       jcfg.modulation.bits_per_symbol)
    np.testing.assert_allclose(oracle.n(got), want, rtol=1e-5,
                               atol=1e-5 * np.abs(want).max())


def _coded_capture(jcfg, rate, seed, snr_db):
    """A coded payload's capture (JAX TX and channel) and its message."""
    msg, txd = jfec.encode_payload(jcfg, seed=seed, rate=rate)
    cap, _ = oracle.jax_capture(jcfg, snr_db=snr_db, seed=seed,
                                tx_data=txd)
    return cap, msg


@pytest.mark.parametrize("rate", RATES)
def test_decode_payload_matches_jax(rate):
    """One decoded tiny capture at 14 dB (2 % raw symbol errors at rate
    3/4): the JAX rx_sig through
    both decode_payloads gives the same bits, and so does the port's own
    decode of the capture; the message is recovered."""
    jcfg = tiny_config(bit_exact=False, pid_max=16,
                       modulation=Modulation.QAM16)
    cfg = oracle.pcfg(jcfg)
    cap, msg = _coded_capture(jcfg, rate, 3, 14.0)
    jr = oracle.jax_decode(cap, jcfg)
    sig = np.array(jr.rx_sig)
    want = jn(jfec.decode_payload(jnp.asarray(sig), jcfg, 0.1, rate=rate))
    got = fec.decode_payload(torch.as_tensor(sig), cfg, 0.1, rate=rate)
    np.testing.assert_array_equal(oracle.n(got), want)
    r = rx.make_decoder(cfg, device="cpu")(cap)
    own = fec.decode_payload(r.rx_sig, cfg, torch.tensor(0.1), rate=rate)
    np.testing.assert_array_equal(oracle.n(own), want)
    np.testing.assert_array_equal(want, msg)


def test_decode_payload_ml_and_decode_data_route_match_jax():
    """ML decodes keep Y; decode_payload_ml and decode_data's ML route
    equal the JAX package's on the same capture (tests/test_fec.py's ML
    route check)."""
    jcfg = tiny_config(bit_exact=False, pid_max=32, sync_fallback=True,
                       modulation=Modulation.QAM16, detector=Detector.ML)
    cfg = oracle.pcfg(jcfg)
    data = b"ml route check " * 20
    txd = jfec.encode_data(data, jcfg)
    cap, _ = oracle.jax_capture(jcfg, snr_db=12.0, seed=1, tx_data=txd)
    jr = jrx.decode(jnp.asarray(cap), jcfg)
    r = rx.make_decoder(cfg, device="cpu")(cap)
    assert r.Y is not None and jr.Y is not None
    want = jn(jfec.decode_payload_ml(jr, jcfg))
    np.testing.assert_array_equal(oracle.n(fec.decode_payload_ml(r, cfg)),
                                  want)
    out, ok = fec.decode_data(r, cfg)
    assert ok and out == data
    assert (out, ok) == jfec.decode_data(jr, jcfg)
    with pytest.raises(ValueError):
        fec.decode_payload_ml(r._replace(Y=None), cfg)


def test_coded_siso_guard_band_chain_matches_jax():
    """The wifi_like shape (SISO, guard bands and pilots, CFO, fallback)
    with a coded payload: the port's decode and decode_payload recover
    the message the JAX chain does."""
    from rub_mimo_tpu.models import presets as jpresets

    jcfg, jspec = jpresets.wifi_like(pid_max=12)
    cfg = oracle.pcfg(jcfg)
    msg, txd = jfec.encode_payload(jcfg, seed=2)
    cap, _ = oracle.jax_capture(jcfg, snr_db=jspec.snr_db, seed=jspec.seed,
                                delay=jspec.delay, tx_data=txd,
                                flat=jspec.flat, num_taps=jspec.num_taps,
                                cfo_subcarriers=jspec.cfo_subcarriers)
    jr = oracle.jax_decode(cap, jcfg)
    want = jn(jfec.decode_payload(jr.rx_sig, jcfg))
    r = rx.make_decoder(cfg, device="cpu")(cap)
    np.testing.assert_array_equal(oracle.n(fec.decode_payload(r.rx_sig, cfg)),
                                  want)
    np.testing.assert_array_equal(want, msg)


@pytest.mark.parametrize("interleave", [True, False],
                         ids=["interleaved", "plain"])
@pytest.mark.parametrize("rate", RATES)
def test_decode_through_the_soft_llr_rows_matches_jax(rate, interleave):
    """The coded decode the way the soft-LLR rows kernel composes it
    (kernels.soft_llr.soft_llr_rows' plain version on the CPU): the same
    numpy symbols of a windowed codeword (260 frames of QPSK at M = 64,
    past 4 x 4096 steps), the transmitted points with seeded noise at
    ~9 dB, through both packages' decode_payload, and their JAX LLRs
    through both _decode_from_llrs: equal bits (tolerance 0), the message
    recovered."""
    jcfg = tiny_config(bit_exact=False, pid_max=260,
                       modulation=Modulation.QPSK)
    cfg = oracle.pcfg(jcfg)
    msg, txd = jfec.encode_payload(jcfg, seed=9, rate=rate,
                                   interleave_bits=interleave)
    _, lanes = fec._lanes(cfg)
    rng = np.random.default_rng(len(rate) + 2 * interleave)
    pts = jconst.table(jcfg.modulation)[txd]
    sig = (pts + (rng.standard_normal(pts.shape)
                  + 1j * rng.standard_normal(pts.shape)) * 0.25
           ).astype(np.complex64)
    want = jn(jfec.decode_payload(jnp.asarray(sig), jcfg, 0.125,
                                  interleave_bits=interleave, rate=rate))
    got = fec.decode_payload(torch.as_tensor(sig), cfg, 0.125,
                             interleave_bits=interleave, rate=rate)
    np.testing.assert_array_equal(oracle.n(got), want)
    np.testing.assert_array_equal(want, msg)
    llrs = np.array(jconst.soft_demodulate_llr(
        jnp.asarray(sig[lanes]), jcfg.modulation, 0.125)).reshape(
            len(lanes), -1)
    np.testing.assert_array_equal(
        oracle.n(fec._decode_from_llrs(torch.as_tensor(llrs), cfg,
                                       interleave, rate)),
        jn(jfec._decode_from_llrs(jnp.asarray(llrs), jcfg, interleave,
                                  rate)))


@pytest.mark.parametrize("rate,interleave", [("3/4", False), ("2/3", True)])
def test_decode_payload_ml_through_the_soft_llr_rows_matches_jax(
        rate, interleave):
    """decode_payload_ml (the LLR-input form of the soft-LLR rows) at
    other rates and without the interleaver: the port's decode of the
    same capture against the JAX package's, equal bits."""
    jcfg = tiny_config(bit_exact=False, pid_max=32, sync_fallback=True,
                       modulation=Modulation.QAM16, detector=Detector.ML)
    cfg = oracle.pcfg(jcfg)
    msg, txd = jfec.encode_payload(jcfg, seed=4, rate=rate,
                                   interleave_bits=interleave)
    cap, _ = oracle.jax_capture(jcfg, snr_db=16.0, seed=2, tx_data=txd)
    jr = jrx.decode(jnp.asarray(cap), jcfg)
    r = rx.make_decoder(cfg, device="cpu")(cap)
    want = jn(jfec.decode_payload_ml(jr, jcfg, interleave_bits=interleave,
                                     rate=rate))
    got = fec.decode_payload_ml(r, cfg, interleave_bits=interleave,
                                rate=rate)
    np.testing.assert_array_equal(oracle.n(got), want)
    np.testing.assert_array_equal(want, msg)
