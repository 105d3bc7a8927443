"""Port parity of the streaming decoder's live SFO correction
(StreamingDecoder(sfo_correct=True)) against the JAX package's, on
tests/test_sfo_streaming.py's three-burst capture at 100 ppm (built by
the JAX package's TX and channel), chunk by chunk.

Tolerances: sfo_hat within 1e-6 (delta; the moment z is summed in
another order), every burst's sync index and decisions equal, the
number of bursts equal; rx_sig within rtol 1e-3, atol 1e-4 (the tracked
tolerance of tests/test_torch_streaming.py: each refit goes through a
matrix inverse)."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from rub_mimo_tpu.config import Modulation, tiny_config
from rub_mimo_tpu.io import simulator as jsim
from rub_mimo_tpu.ofdm import framegen as jframegen
from rub_mimo_tpu.pipeline import streaming as jstreaming
from rub_mimo_tpu_torch.pipeline import streaming
import torch_oracle as oracle
from torch_oracle import HostReads

CHUNK = 512


def three_burst_capture(cfg, ppm):
    """tests/test_sfo_streaming.py::_three_burst_capture: three frames of
    payload seeds 1, 2, 3 a replay window and three symbols apart."""
    spec = jsim.ChannelSpec(snr_db=35.0, delay=0, trailing=0, seed=3,
                            sfo_ppm=ppm)
    h = jsim.draw_channel(spec, 2, 2)
    ds = [jframegen.generate_payload_symbols(cfg, seed=s) for s in (1, 2, 3)]
    txs = [jframegen.transmit_frame(cfg, jnp.asarray(d)) for d in ds]
    gap = cfg.window_len + 3 * cfg.symbol_len
    parts = [jnp.zeros((2, 300), jnp.complex64)]
    for t in txs:
        parts += [t, jnp.zeros((2, max(64, gap - t.shape[-1])),
                               jnp.complex64)]
    parts.append(jnp.zeros((2, 500), jnp.complex64))
    cap = jsim.apply_channel(jnp.concatenate(parts, axis=-1), h, spec, cfg)
    return np.array(cap), [np.asarray(d) for d in ds]


def chunks_of(cap: np.ndarray):
    nc = -(-cap.shape[-1] // CHUNK)
    padded = np.pad(cap, ((0, 0), (0, nc * CHUNK - cap.shape[-1])))
    return [padded[:, i * CHUNK:(i + 1) * CHUNK] for i in range(nc)]


@pytest.fixture(scope="module", params=[16, 64])
def streams(request):
    """(config, capture, payloads, port decoder, JAX decoder), both
    streamed with sfo_correct and finalized."""
    jcfg = tiny_config(bit_exact=False, pid_max=request.param,
                       modulation=Modulation.QAM16, track_channel=True,
                       sync_fallback=True)
    cap, ds = three_burst_capture(jcfg, 100.0)
    dec = streaming.StreamingDecoder(oracle.pcfg(jcfg), device="cpu",
                                     chunk_size=CHUNK, sfo_correct=True)
    ref = jstreaming.StreamingDecoder(jcfg, chunk_size=CHUNK,
                                      sfo_correct=True)
    for c in chunks_of(cap):
        got = [k for k, _ in dec.push(c)]
        assert got == [k for k, _ in ref.push(c)]
    assert [k for k, _ in dec.finalize()] == [k for k, _ in ref.finalize()]
    return jcfg, cap, ds, dec, ref


def test_streaming_sfo_matches_jax(streams):
    jcfg, _, ds, dec, ref = streams
    assert len(dec.bursts) == len(ref.bursts) == 3
    assert dec._resampler is not None
    assert abs(dec.sfo_hat - ref.sfo_hat) < 1e-6, (dec.sfo_hat, ref.sfo_hat)
    n = jcfg.pid_max * jcfg.M_occupied
    sers = []
    for (si, sig, data), (jsi, jsig, jdata), d in zip(
            dec.burst_results(), ref.burst_results(), ds):
        assert si == jsi
        np.testing.assert_array_equal(oracle.n(data), np.asarray(jdata))
        np.testing.assert_allclose(oracle.n(sig), np.asarray(jsig),
                                   rtol=1e-3, atol=1e-4)
        sers.append((oracle.n(data)[:, :n] != d[:, :n]).mean())
    for b, jb in zip(dec.bursts, ref.bursts):
        assert (b.sync_index, b.decode_start) == (jb.sync_index,
                                                  jb.decode_start)
    # the JAX test's thresholds (at its 64 frames): the estimate near the
    # injected offset, the corrected bursts better than the first
    if jcfg.pid_max == 64:
        assert abs(dec.sfo_hat * 1e6 - 100.0) < 15.0, dec.sfo_hat
        assert sers[1] < 0.6 * sers[0] and sers[2] < 0.6 * sers[0], sers


def test_streaming_sfo_reads_by_phase(streams):
    """Over the same capture: a seek push reads one flag, a collect or a
    payload push (the moment z accumulating on the device, the resampler
    engaged from the second burst on) reads and uploads nothing."""
    jcfg, cap, _, _, _ = streams
    dec = streaming.StreamingDecoder(oracle.pcfg(jcfg), device="cpu",
                                     chunk_size=CHUNK, sfo_correct=True)
    seen = {"seek": 0, "collect": 0, "payload": 0}
    resampled = 0
    for c in chunks_of(cap):
        c = torch.as_tensor(c)
        before, n_bursts, reads = dec.phase, len(dec.bursts), dec.host_reads
        with HostReads() as spy:
            dec.push(c)
        if dec.phase != before or len(dec.bursts) != n_bursts:
            continue  # a transition: sync fired, estimate, or re-arm
        want = 1 if before == "seek" else 0
        if want == 0 or dec._resampler is None:
            assert len(spy.hits) == want, (before, spy.hits)
            assert dec.host_reads - reads == want
        seen[before] += 1
        resampled += before == "payload" and dec._resampler is not None
    assert all(v >= 1 for v in seen.values()) and seen["payload"] >= 4, seen
    assert resampled >= 2


def test_push_block_with_sfo_equals_push(streams):
    """push_block takes the chunk path once the resampler is engaged: the
    same bursts, sfo_hat and decisions as push."""
    jcfg, cap, _, dec, _ = streams
    blk = streaming.StreamingDecoder(oracle.pcfg(jcfg), device="cpu",
                                     chunk_size=CHUNK, sfo_correct=True)
    chunks = chunks_of(cap)
    for i in range(0, len(chunks), 4):
        blk.push_block(np.concatenate(chunks[i:i + 4], axis=-1))
    blk.finalize()
    assert blk.sfo_hat == dec.sfo_hat
    for (si, _, data), (bsi, _, bdata) in zip(dec.burst_results(),
                                              blk.burst_results()):
        assert si == bsi
        assert torch.equal(data, bdata)


def test_streaming_sfo_requires_tracking():
    cfg = oracle.pcfg(tiny_config(bit_exact=False))
    with pytest.raises(ValueError, match="track_channel"):
        streaming.StreamingDecoder(cfg, device="cpu", chunk_size=256,
                                   sfo_correct=True)
    # with the tracking, it takes the front-end compensation too
    dec = streaming.StreamingDecoder(cfg.replace(track_channel=True,
                                                 track_block_frames=4),
                                     device="cpu", chunk_size=256,
                                     sfo_correct=True, frontend_comp=True)
    assert dec._fe_on and dec._sfo_on
