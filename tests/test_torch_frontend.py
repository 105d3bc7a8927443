"""Port parity: the RX front end (estimate/frontend.py), the simulator's
drift, IQ imbalance and DC offset, inject_fault, and the streaming
decoder's front-end compensation.

Tolerances: the moments and the compensated capture within rtol 1e-5 /
atol 1e-6 of the JAX package's; the noise-free channel within atol 1e-5;
decisions equal.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from rub_mimo_tpu.config import Modulation, tiny_config
from rub_mimo_tpu.estimate import frontend as jfrontend
from rub_mimo_tpu.io import simulator as jsim
from rub_mimo_tpu.ofdm import framegen as jfg
from rub_mimo_tpu.pipeline import streaming as jstreaming
from rub_mimo_tpu_torch.estimate import frontend
from rub_mimo_tpu_torch.io import simulator
from rub_mimo_tpu_torch.pipeline import streaming
import torch_oracle as oracle
from torch_oracle import HostReads

# tests/test_frontend.py's impairment: 1 dB / 5 degrees and a complex DC
IMPAIR = dict(iq_amp_db=1.0, iq_phase_deg=5.0, dc_offset=0.05 + 0.03j)
CFG = tiny_config(bit_exact=False, pid_max=32, modulation=Modulation.QAM16)
PCFG = oracle.pcfg(CFG)
CHUNK = 256


def _true_w(amp_db, phase_deg):
    g = 10.0 ** (amp_db / 20.0)
    phi = np.deg2rad(phase_deg)
    return ((1.0 - g * np.exp(-1j * phi)) / 2.0
            / np.conj((1.0 + g * np.exp(1j * phi)) / 2.0))


@pytest.fixture(scope="module")
def impaired():
    """(capture, tx_data) of the JAX simulator with the impairment."""
    return oracle.jax_capture(CFG, snr_db=35.0, delay=333, seed=5, **IMPAIR)


def test_moments_and_compensation_match_jax(impaired):
    cap, _ = impaired
    dc, w = frontend.estimate_frontend(oracle.t(cap))
    jdc, jw = jfrontend.estimate_frontend(jnp.asarray(cap))
    assert dc.dtype == w.dtype == torch.complex64
    np.testing.assert_allclose(oracle.n(dc), np.asarray(jdc), rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_allclose(oracle.n(w), np.asarray(jw), rtol=1e-5,
                               atol=1e-6)
    assert abs(complex(oracle.n(w)[0]) - _true_w(1.0, 5.0)) < 0.04
    ours = frontend.compensate(oracle.t(cap), dc, w)
    theirs = jfrontend.compensate(jnp.asarray(cap), jdc, jw)
    np.testing.assert_allclose(oracle.n(ours), np.asarray(theirs),
                               rtol=1e-5, atol=1e-6)


def test_decode_with_frontend_matches_jax(impaired):
    """Decisions equal the JAX package's decode_with_frontend; the
    compensation rescues a capture the imbalance spoils."""
    cap, tx = impaired
    n = CFG.pid_max * CFG.M_occupied
    got, dc, w = frontend.decode_with_frontend(cap, PCFG, device="cpu")
    ref, jdc, jw = jfrontend.decode_with_frontend(jnp.asarray(cap), CFG)
    assert bool(got.synced) and bool(ref.synced)
    np.testing.assert_array_equal(oracle.n(got.rx_data),
                                  np.asarray(ref.rx_data))
    ser = (oracle.n(got.rx_data)[:, :n] != tx[:, :n]).mean()
    raw = oracle.jax_decode(cap, CFG)
    ser_raw = (np.asarray(raw.rx_data)[:, :n] != tx[:, :n]).mean()
    assert ser < 0.02 < ser_raw, (ser, ser_raw)


@pytest.mark.parametrize("kw", [
    dict(drift_rate=2e-5), IMPAIR, dict(dc_offset=0.1),
    dict(drift_rate=1e-5, **IMPAIR)], ids=["drift", "iq_dc", "dc", "all"])
def test_apply_channel_impairments_match_jax(kw):
    cfg = oracle.TINY
    tx = np.asarray(jfg.transmit_frame(
        cfg, jnp.asarray(jfg.generate_payload_symbols(cfg, seed=4))))
    common = dict(snr_db=float("inf"), delay=37, trailing=55, seed=9, **kw)
    spec, jspec = simulator.ChannelSpec(**common), jsim.ChannelSpec(**common)
    h = simulator.draw_channel(spec, 2, 2)
    ours = oracle.n(simulator.apply_channel(oracle.t(tx), h, spec))
    ref = np.asarray(jsim.apply_channel(jnp.asarray(tx), h, jspec, cfg))
    assert ours.dtype == np.complex64 and ours.shape == ref.shape
    np.testing.assert_allclose(ours, ref, rtol=0, atol=1e-5)


@pytest.mark.parametrize("kind", ["truncate", "nan_burst", "dropout",
                                  "spike"])
def test_inject_fault_matches_jax(kind):
    cap = (np.random.default_rng(11).standard_normal((2, 1000))
           + 0j).astype(np.complex64)
    for kw in (dict(), dict(position=0.1, length=17)):
        ours = simulator.inject_fault(cap, kind, **kw)
        np.testing.assert_array_equal(ours, jsim.inject_fault(cap, kind, **kw))
        assert ours is not cap
    with pytest.raises(ValueError, match="fault kind"):
        simulator.inject_fault(cap, "flood")


def _chunks(cap: np.ndarray):
    T = cap.shape[-1]
    nc = -(-T // CHUNK)
    padded = np.zeros((cap.shape[0], nc * CHUNK), np.complex64)
    padded[:, :T] = cap
    return [padded[:, i * CHUNK:(i + 1) * CHUNK] for i in range(nc)]


def _feed(dec, chunks, block_at=None):
    """Push chunk by chunk; from index block_at, four chunks as one
    push_block."""
    i = 0
    while i < len(chunks):
        if block_at is not None and i == block_at:
            dec.push_block(np.concatenate(chunks[i:i + 4], axis=-1))
            i += 4
        else:
            dec.push(chunks[i])
            i += 1
    dec.finalize()
    return dec


@pytest.fixture(scope="module")
def impaired_late():
    """The impaired capture with the frame after eight chunks of noise:
    a push_block after the warm-up seeks before the frame."""
    return oracle.jax_capture(CFG, snr_db=35.0, delay=8 * CHUNK + 333,
                              seed=5, **IMPAIR)


@pytest.mark.parametrize("block_at", [None, 4], ids=["push", "push_block"])
def test_streamed_frontend_matches_jax(impaired_late, block_at):
    """StreamingDecoder(frontend_comp=True, warmup_chunks=4): decisions
    equal JAX streaming's, chunk by chunk and with one push_block right
    after the warm-up (the compensated fast seek)."""
    cap, _ = impaired_late
    chunks = _chunks(cap)
    ours = _feed(streaming.StreamingDecoder(
        PCFG, device="cpu", chunk_size=CHUNK, frontend_comp=True,
        warmup_chunks=4), chunks, block_at)
    theirs = _feed(jstreaming.StreamingDecoder(
        CFG, chunk_size=CHUNK, frontend_comp=True, warmup_chunks=4),
        chunks, block_at)
    assert ours.synced and theirs.synced
    assert ours.sync_index == theirs.sync_index
    _, data = ours.result()
    _, jdata = theirs.result()
    np.testing.assert_array_equal(oracle.n(data), np.asarray(jdata))


def test_streamed_frontend_reads_nothing_in_the_payload(impaired):
    """The moments and the compensation stay on the device: a payload
    push reads nothing back; a stream that ends inside the warm-up is
    estimated on what came."""
    cap, _ = impaired
    chunks = [torch.as_tensor(c) for c in _chunks(cap)]
    # a first stream makes the constant tables (uploaded once)
    _feed(streaming.StreamingDecoder(PCFG, device="cpu", chunk_size=CHUNK,
                                     frontend_comp=True), chunks)
    dec = streaming.StreamingDecoder(PCFG, device="cpu", chunk_size=CHUNK,
                                     frontend_comp=True, warmup_chunks=4)
    payload_pushes = 0
    for c in chunks:
        before, reads = dec.phase, dec.host_reads
        with HostReads() as spy:
            dec.push(c)
        if before == dec.phase == "payload":
            assert spy.hits == [] and dec.host_reads == reads
            payload_pushes += 1
    assert payload_pushes >= 2
    short = streaming.StreamingDecoder(PCFG, device="cpu", chunk_size=CHUNK,
                                       frontend_comp=True, warmup_chunks=4)
    short.push(_chunks(cap)[0])
    assert short._fe_dc is None
    short.finalize()
    assert short._fe_dc is not None and short.gpos == CHUNK
