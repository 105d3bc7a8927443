"""Port parity of the streaming decoder: rub_mimo_tpu_torch.pipeline.
streaming against the JAX package's StreamingDecoder / decode_stream on
the same numpy captures, chunk by chunk (the captures and seeds of
tests/test_streaming.py and tests/test_matrix.py).

Tolerances: synced, sync_index, decode_start and the frame indices each
push emits equal; cfo_hat within 1e-5 of JAX streaming's; result()
rx_data equal (in the low-SNR fallback cases equal but where the plain
demap's two best scores lie within 1e-4: a tie that float rounding may
break either way); rx_sig within rtol 1e-4, atol 1e-5 (the JAX test's),
except under track_channel, where each group's LS refit goes through a
matrix inverse summed in another order and the rounding grows from group
to group (past rtol 1e-4 by the eighth frame): there the tolerance of
tests/test_torch_detectors.py's tracked channel, rtol 1e-3, atol 1e-4;
each BurstRecord's G within rtol 1e-4."""

import numpy as np
import pytest
import torch

from rub_mimo_tpu.config import Detector, tiny_config
from rub_mimo_tpu.io import simulator as jsim
from rub_mimo_tpu.pipeline import streaming as jstreaming
from rub_mimo_tpu_torch.ofdm import constellation
from rub_mimo_tpu_torch.pipeline import streaming
import torch_oracle as oracle
from test_matrix import CASES, DEFAULT_SPEC, SPECS

TIE_MARGIN = 1e-4


def capture(cfg, spec) -> np.ndarray:
    cap, _, _ = jsim.simulate_capture(cfg, spec)
    return np.array(cap)


def chunks_of(cap: np.ndarray, C: int):
    nc = -(-cap.shape[-1] // C)
    padded = np.pad(cap, ((0, 0), (0, nc * C - cap.shape[-1])))
    return [padded[:, i * C:(i + 1) * C] for i in range(nc)]


def run(dec, cap: np.ndarray, C: int):
    """Push cap chunk by chunk, then finalize: (decoder, the frame indices
    each push and the finalize emitted)."""
    emitted = [[k for k, _ in dec.push(c)] for c in chunks_of(cap, C)]
    emitted.append([k for k, _ in dec.finalize()])
    return dec, emitted


def run_both(jcfg, cap: np.ndarray, C: int):
    """(port run on the CPU, JAX run) of one capture at chunk C."""
    return (run(streaming.StreamingDecoder(oracle.pcfg(jcfg), device="cpu",
                                           chunk_size=C), cap, C),
            run(jstreaming.StreamingDecoder(jcfg, chunk_size=C), cap, C))


def assert_data_equal(got: torch.Tensor, ref: np.ndarray, sig: np.ndarray,
                      cfg, ties: bool) -> None:
    """rx_data equal; with ``ties``, a differing decision must be a
    near-tie of the reference's scores at its symbol."""
    got = oracle.n(got)
    if not ties:
        np.testing.assert_array_equal(got, ref)
        return
    bad = got != ref
    if bad.any():
        c = constellation.demap_planes(constellation.table(
            oracle.pcfg(cfg).modulation))
        y = sig[bad][:, None]
        scores = np.sort(y.real * c[0] + y.imag * c[1] - c[2], axis=-1)
        assert (scores[:, -1] - scores[:, -2] < TIE_MARGIN).all()


SIG_TOL = dict(rtol=1e-4, atol=1e-5)
TRACKED_SIG_TOL = dict(rtol=1e-3, atol=1e-4)


def assert_stream_matches(got, ref, cfg, *, ties: bool = False,
                          sig_tol: dict = SIG_TOL) -> None:
    """The port's streamed decode (decoder, emissions) against JAX's."""
    (p, p_emit), (j, j_emit) = got, ref
    assert p.synced == j.synced and p.synced
    assert p.sync_index == j.sync_index
    assert p.decode_start == j.decode_start
    assert p_emit == j_emit
    assert abs(p.cfo_hat - j.cfo_hat) < 1e-5
    sig, data = p.result()
    jsig, jdata = j.result()
    assert_data_equal(data, np.asarray(jdata), np.asarray(jsig), cfg, ties)
    np.testing.assert_allclose(oracle.n(sig), np.asarray(jsig), **sig_tol)
    assert len(p.bursts) == len(j.bursts)
    for b, jb in zip(p.bursts, j.bursts):
        assert (b.sync_index, b.decode_start, sorted(b.frames)) == (
            jb.sync_index, jb.decode_start, sorted(jb.frames))
        np.testing.assert_allclose(oracle.n(b.G), np.asarray(jb.G),
                                   rtol=1e-4, atol=1e-6)


BASE = tiny_config(bit_exact=False)
BASE_SPEC = jsim.ChannelSpec(snr_db=35.0, delay=501, seed=11)


@pytest.fixture(scope="module")
def base_runs():
    """tests/test_streaming.py's capture at chunks 128, 256 and 1024."""
    cap = capture(BASE, BASE_SPEC)
    return {C: run_both(BASE, cap, C) for C in (128, 256, 1024)}


@pytest.mark.parametrize("chunk", [128, 256, 1024])
def test_streaming_matches_jax(base_runs, chunk):
    assert_stream_matches(*base_runs[chunk], BASE)


def test_streaming_emits_incrementally(base_runs):
    (p, emitted), _ = base_runs[256]
    assert sum(1 for ks in emitted if ks) >= 2
    assert sorted(k for ks in emitted for k in ks) == list(range(8))
    for k, f in p.bursts[0].frames.items():
        assert f.shape == (2, BASE.M_occupied) and f.dtype == torch.complex64


@pytest.mark.parametrize("name", list(CASES))
def test_streaming_matrix_case_matches_jax(name):
    """tests/test_matrix.py's feature combinations at chunk 256."""
    cfg = tiny_config(**CASES[name])
    spec = SPECS.get(name, DEFAULT_SPEC)
    assert_stream_matches(*run_both(cfg, capture(cfg, spec), 256), cfg,
                          ties=name == "fallback_lowsnr")


STREAM_CASES = {
    "mmse": (tiny_config(bit_exact=False, detector=Detector.MMSE,
                         mmse_noise_var=1e-3),
             jsim.ChannelSpec(snr_db=35.0, delay=130, seed=4), False),
    # 2-frame groups: a 256-sample block owns three 80-sample symbols, so
    # its last group is one frame and a zero frame
    "track_channel": (tiny_config(bit_exact=False, track_channel=True,
                                  track_block_frames=2),
                      BASE_SPEC, False),
    "fallback_cfo_12db": (tiny_config(bit_exact=False, sync_fallback=True,
                                      correct_cfo=True),
                          jsim.ChannelSpec(snr_db=12.0, delay=350, seed=13,
                                           cfo_subcarriers=0.11), True),
}


@pytest.mark.parametrize("case", list(STREAM_CASES))
def test_streaming_option_matches_jax(case):
    cfg, spec, ties = STREAM_CASES[case]
    got, ref = run_both(cfg, capture(cfg, spec), 256)
    assert_stream_matches(got, ref, cfg, ties=ties, sig_tol=(
        TRACKED_SIG_TOL if cfg.track_channel else SIG_TOL))
    if case == "fallback_cfo_12db":
        assert got[0].bursts[0].fb_used == ref[0].bursts[0].fb_used
