"""Port parity of the streaming decoder's multi-burst re-arm and
push_block against the JAX package (tests/test_streaming.py's captures),
the host reads each phase makes (counted on the CPU by the operators it
dispatches), and the decoder's refusals.

Tolerances: as tests/test_torch_streaming.py (sync_index, decode_start,
emitted frame indices and rx_data equal; rx_sig within rtol 1e-4, atol
1e-5; each burst's G within rtol 1e-4); push_block against the port's
own push bit for bit."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from rub_mimo_tpu.config import tiny_config
from rub_mimo_tpu.io import simulator as jsim
from rub_mimo_tpu.ofdm import framegen as jframegen
from rub_mimo_tpu.pipeline import streaming as jstreaming
from rub_mimo_tpu_torch.io import simulator
from rub_mimo_tpu_torch.pipeline import streaming
import torch_oracle as oracle
from test_torch_streaming import (assert_stream_matches, capture, chunks_of,
                                  run, run_both)
from torch_oracle import HostReads

BASE = tiny_config(bit_exact=False)
PBASE = oracle.pcfg(BASE)


def two_burst_capture() -> np.ndarray:
    """tests/test_streaming.py::test_streaming_multiburst_rearm's capture:
    two frames of different payloads a replay window and three symbols
    apart."""
    cfg = BASE
    spec = jsim.ChannelSpec(snr_db=35.0, delay=0, trailing=0, seed=5)
    h = jsim.draw_channel(spec, 2, 2)
    tx = [jframegen.transmit_frame(cfg, jnp.asarray(
        jframegen.generate_payload_symbols(cfg, seed=s))) for s in (1, 2)]
    gap = cfg.window_len + 3 * cfg.symbol_len
    z = [jnp.zeros((2, n), jnp.complex64)
         for n in (300, max(64, gap - tx[0].shape[-1]), 500)]
    return np.array(jsim.apply_channel(
        jnp.concatenate([z[0], tx[0], z[1], tx[1], z[2]], axis=-1), h, spec,
        cfg))


@pytest.mark.parametrize("chunk", [256, 1024])
def test_multiburst_rearm_matches_jax(chunk):
    got, ref = run_both(BASE, two_burst_capture(), chunk)
    assert_stream_matches(got, ref, BASE)
    p, j = got[0], ref[0]
    bursts, jbursts = p.burst_results(), j.burst_results()
    assert len(bursts) == len(jbursts) == 2
    for (si, sig, data), (jsi, jsig, jdata) in zip(bursts, jbursts):
        assert si == jsi
        np.testing.assert_array_equal(oracle.n(data), jdata)
        np.testing.assert_allclose(oracle.n(sig), jsig, rtol=1e-4, atol=1e-5)
    assert not torch.equal(bursts[0][2], bursts[1][2])


def push_blocks(dec, cap: np.ndarray, B: int):
    """Feed cap in blocks of B samples (the last zero-padded), then
    finalize: (decoder, the frame indices each call emitted)."""
    emitted = [[k for k, _ in dec.push_block(b)] for b in chunks_of(cap, B)]
    emitted.append([k for k, _ in dec.finalize()])
    return dec, emitted


BLOCK_CASES = {  # name -> (capture delay, chunks a block)
    "K2": (900, 2), "K5": (900, 5),
    # sync deep in the capture: all-seek blocks first, then a fire
    "late_sync": (2000, 4),
}
CHUNK = 128


@pytest.fixture(scope="module")
def block_captures():
    return {d: capture(BASE, jsim.ChannelSpec(snr_db=35.0, delay=d, seed=11))
            for d in {d for d, _ in BLOCK_CASES.values()}}


@pytest.mark.parametrize("case", list(BLOCK_CASES))
def test_push_block_matches_push_and_jax(block_captures, case):
    delay, K = BLOCK_CASES[case]
    cap = block_captures[delay]
    by_push = run(streaming.StreamingDecoder(PBASE, device="cpu",
                                             chunk_size=CHUNK), cap, CHUNK)[0]
    got = push_blocks(streaming.StreamingDecoder(PBASE, device="cpu",
                                                 chunk_size=CHUNK),
                      cap, K * CHUNK)
    ref = push_blocks(jstreaming.StreamingDecoder(BASE, chunk_size=CHUNK),
                      cap, K * CHUNK)
    assert_stream_matches(got, ref, BASE)
    p = got[0]
    assert (p.sync_index, p.decode_start) == (by_push.sync_index,
                                              by_push.decode_start)
    for a, b in zip(p.result(), by_push.result()):
        assert torch.equal(a, b)
    # fewer reads than a push a chunk: one a block while seeking
    assert p.host_reads < by_push.host_reads


@pytest.fixture(scope="module")
def port_capture():
    """A port-simulated capture (no JAX) whose frame starts after four
    chunks of 128, and a warm-up stream of it (the device tables are
    made on first use)."""
    spec = simulator.ChannelSpec(snr_db=35.0, delay=900, seed=11)
    cap = simulator.simulate_capture(PBASE, spec, device="cpu")[0]
    streaming.decode_stream(cap, PBASE, CHUNK, device="cpu").finalize()
    return cap


def test_host_reads_by_phase(port_capture):
    """A seek push without the fallback reads one scalar (did it fire); a
    collect push and a payload push read nothing and upload nothing."""
    dec = streaming.StreamingDecoder(PBASE, device="cpu", chunk_size=CHUNK)
    seen = {"seek": 0, "collect": 0, "payload": 0}
    for c in torch.split(chunks_of_tensor(port_capture), 1):
        before, n_bursts, reads = dec.phase, len(dec.bursts), dec.host_reads
        with HostReads() as spy:
            dec.push(c[0])
        if dec.phase != before or len(dec.bursts) != n_bursts:
            continue  # a transition: sync fired, estimate, or re-arm
        want = 1 if before == "seek" else 0
        assert len(spy.hits) == want, (before, spy.hits)
        assert spy.hits == [] or "_local_scalar_dense" in spy.hits[0][0]
        assert dec.host_reads - reads == want
        seen[before] += 1
    assert all(v >= 2 for v in seen.values()), seen
    assert dec.bursts and dec.bursts[0].sync_index == dec.sync_index


def chunks_of_tensor(cap: torch.Tensor) -> torch.Tensor:
    """cap zero-padded and cut into chunks of CHUNK: [n, S, CHUNK]."""
    nc = -(-cap.shape[-1] // CHUNK)
    padded = torch.nn.functional.pad(cap, (0, nc * CHUNK - cap.shape[-1]))
    return padded.reshape(cap.shape[0], nc, CHUNK).transpose(0, 1)


def test_push_block_without_a_fire_reads_once(port_capture):
    """Four seek chunks before the frame: one read for the block."""
    dec = streaming.StreamingDecoder(PBASE, device="cpu", chunk_size=CHUNK)
    block = port_capture[:, :4 * CHUNK].contiguous()
    with HostReads() as spy:
        assert dec.push_block(block) == []
    assert len(spy.hits) == 1 and dec.host_reads == 1
    assert dec.phase == "seek" and dec.gpos == 4 * CHUNK


def test_streaming_refuses():
    with pytest.raises(TypeError):
        streaming.StreamingDecoder(BASE, device="cpu")
    with pytest.raises(TypeError):
        streaming.decode_stream(np.zeros((2, 256), np.complex64), BASE,
                                256, device="cpu")
    # the front-end compensation is ported (tests/test_torch_frontend.py)
    assert streaming.StreamingDecoder(PBASE, device="cpu",
                                      frontend_comp=True)._fe_on
    # live SFO correction is ported; it needs the tracked refits
    with pytest.raises(ValueError, match="track_channel"):
        streaming.StreamingDecoder(PBASE, device="cpu", sfo_correct=True)
    with pytest.raises(ValueError, match="symbol_len"):
        streaming.StreamingDecoder(PBASE, device="cpu",
                                   chunk_size=PBASE.symbol_len - 1)
    dec = streaming.StreamingDecoder(PBASE, device="cpu", chunk_size=CHUNK)
    for shape in ((2, CHUNK + 1), (3, CHUNK), (CHUNK,)):
        with pytest.raises(ValueError, match="chunk must be"):
            dec.push(torch.zeros(shape, dtype=torch.complex64))
    for shape in ((2, CHUNK + 1), (1, 2 * CHUNK), (2 * CHUNK,)):
        with pytest.raises(ValueError, match="push_block needs"):
            dec.push_block(torch.zeros(shape, dtype=torch.complex64))
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            streaming.StreamingDecoder(PBASE, device="cuda")
