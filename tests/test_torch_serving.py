"""Port parity of the serving entry points: rub_mimo_tpu_torch.pipeline.
rx.make_serving_decoder and decode_all against the JAX package's on the
same numpy captures, the device-start payload window against the JAX
extract_payload, the decoders' refusals, and, for each path the port
serves from a CUDA graph, an eager decode that reads nothing back to the
host (checked on the CPU by the operators it dispatches).

Tolerances: integer fields equal; G and W within rtol 1e-4 and cfo_hat
within 1e-5 (torch_oracle.assert_decode_matches_jax); rx_sig within rtol
1e-4, atol 1e-5 (tests/test_torch_decode.py); the payload window bit
for bit."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from rub_mimo_tpu.config import tiny_config
from rub_mimo_tpu.io import simulator as jsim
from rub_mimo_tpu.ofdm import framegen as jframegen
from rub_mimo_tpu.pipeline import rx as jrx
from rub_mimo_tpu_torch import ModemConfig
from rub_mimo_tpu_torch.io import simulator
from rub_mimo_tpu_torch.models import presets
from rub_mimo_tpu_torch.pipeline import rx
import torch_oracle as oracle
from torch_oracle import HostReads

SERVE_CFG = tiny_config(bit_exact=False, pid_max=4)
SERVE_SEEDS = (3, 9)  # tests/test_faults_batch.py's serving stack


def _captures():
    """The serving stack of tests/test_faults_batch.py (two captures cut
    to a common T) and a seeded noise-only capture of the same T, numpy
    complex64 [3, S, T]."""
    caps = []
    for seed in SERVE_SEEDS:
        spec = jsim.ChannelSpec(snr_db=30.0, delay=400 + 37 * seed,
                                seed=seed)
        caps.append(np.asarray(jsim.simulate_capture(SERVE_CFG, spec)[0]))
    T = min(c.shape[-1] for c in caps)
    rng = np.random.default_rng(11)
    noise = ((rng.standard_normal(caps[0][:, :T].shape)
              + 1j * rng.standard_normal(caps[0][:, :T].shape))
             * 0.05).astype(np.complex64)
    return np.stack([c[:, :T] for c in caps] + [noise])


@pytest.fixture(scope="module")
def served():
    stack = _captures()
    jstack = jnp.asarray(stack)
    planes = (jnp.real(jstack).astype(jnp.float32),
              jnp.imag(jstack).astype(jnp.float32))
    return stack, {
        "complex": jrx.make_serving_decoder(SERVE_CFG)(jstack),
        "planes": jrx.make_serving_decoder(
            SERVE_CFG, input_format="planes")(*planes)}


def _item(result, i: int):
    """Capture i of a stacked DecodeResult (JAX or port)."""
    return result._replace(**{f: v[i] for f, v in result._asdict().items()
                              if v is not None})


def _assert_same(got, ref) -> None:
    oracle.assert_decode_matches_jax(got, ref)
    np.testing.assert_allclose(oracle.n(got.rx_sig), np.asarray(ref.rx_sig),
                               rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("input_format", ["complex", "planes"])
def test_serving_decoder_matches_jax(served, input_format):
    """The stacked result against the JAX lax.scan serving decoder (its
    CPU sync is the full-rate scan: sync_impl "xla" here), the noise-only
    capture included; and under the default sync_impl "pallas" each
    capture equals the port's own eager decode of it."""
    stack, ref = served
    pcfg = oracle.pcfg(SERVE_CFG)
    x = torch.as_tensor(stack)
    args = (x,) if input_format == "complex" else (
        x.real.contiguous(), x.imag.contiguous())
    out = rx.make_serving_decoder(pcfg, device="cpu", sync_impl="xla",
                                  input_format=input_format)(*args)
    assert out.metric is None and out.mf_traces is None
    assert out.rx_data.shape == (len(stack),) + tuple(ref[input_format]
                                                     .rx_data.shape[1:])
    for i in range(len(stack)):
        _assert_same(_item(out, i), _item(ref[input_format], i))
    assert [bool(s) for s in out.synced] == [True, True, False]

    pal = rx.make_serving_decoder(pcfg, device="cpu",
                                  input_format=input_format)(*args)
    eager = rx.make_decoder(pcfg, device="cpu", sync_impl="pallas")
    for i in range(len(stack)):
        want = eager(x[i])
        for f, v in _item(pal, i)._asdict().items():
            if f in ("metric", "mf_traces"):
                assert v is None, f
            elif v is None:
                assert getattr(want, f) is None, f
            else:
                assert torch.equal(v, getattr(want, f)), (i, f)


def _two_bursts():
    """tests/test_multiburst.py's two-burst capture and payloads."""
    cfg = tiny_config(bit_exact=False)
    spec = jsim.ChannelSpec(snr_db=35.0, delay=0, trailing=0, seed=5)
    h = jsim.draw_channel(spec, 2, 2)
    data1 = jframegen.generate_payload_symbols(cfg, seed=1)
    data2 = jframegen.generate_payload_symbols(cfg, seed=2)
    tx1 = jframegen.transmit_frame(cfg, jnp.asarray(data1))
    tx2 = jframegen.transmit_frame(cfg, jnp.asarray(data2))
    gap = cfg.window_len + 3 * cfg.symbol_len
    tx = jnp.concatenate(
        [jnp.zeros((2, 300), jnp.complex64), tx1,
         jnp.zeros((2, gap - tx1.shape[-1]), jnp.complex64)
         if gap > tx1.shape[-1] else jnp.zeros((2, 64), jnp.complex64),
         tx2, jnp.zeros((2, 500), jnp.complex64)], axis=-1)
    return cfg, np.asarray(jsim.apply_channel(tx, h, spec, cfg))


def _one_burst():
    """tests/test_multiburst.py's one-burst capture."""
    cfg = tiny_config(bit_exact=False)
    spec = jsim.ChannelSpec(snr_db=35.0, delay=333, seed=7)
    return cfg, np.asarray(jsim.simulate_capture(cfg, spec)[0])


@pytest.mark.parametrize("case,bursts", [("two_bursts", 2), ("one_burst", 1)])
def test_decode_all_matches_jax(case, bursts):
    cfg, cap = {"two_bursts": _two_bursts, "one_burst": _one_burst}[case]()
    ref = jrx.decode_all(jnp.asarray(cap), cfg, max_bursts=4)
    x = oracle.t(cap)
    before = x.clone()
    got = rx.decode_all(x, oracle.pcfg(cfg), device="cpu", max_bursts=4)
    assert torch.equal(x, before)  # the caller's capture is not erased
    assert len(got) == len(ref) == bursts
    for g, r in zip(got, ref):
        _assert_same(g, r)
    if bursts == 2:
        assert int(got[1].sync_index) > int(got[0].sync_index)


# payload window starts of a [2, 1000] capture, 300 samples long
WINDOW_STARTS = {"before": -500, "straddling_start": -100, "at_0": 0,
                 "inside": 200, "straddling_end": 850, "at_end": 1000,
                 "past_end": 1500}


@pytest.mark.parametrize("where", list(WINDOW_STARTS))
def test_extract_payload_device_start_matches_jax(where):
    cstart, plen = WINDOW_STARTS[where], 300
    rng = np.random.default_rng(7)
    iq = (rng.standard_normal((2, 1000))
          + 1j * rng.standard_normal((2, 1000))).astype(np.complex64)
    ref = np.asarray(jrx.extract_payload(jnp.asarray(iq), jnp.int32(cstart),
                                         plen, impl="xla_pad"))
    x = torch.as_tensor(iq)
    for start in (torch.tensor(cstart), cstart):  # device scalar, int
        got = rx.extract_payload(x, start, plen)
        np.testing.assert_array_equal(oracle.n(got), ref)
    out = torch.empty((2, plen), dtype=torch.float32)
    rx.extract_payload(x.real.contiguous(), torch.tensor(cstart), plen,
                       out=out)
    np.testing.assert_array_equal(oracle.n(out), ref.real)


def test_serving_entry_points_refuse():
    pcfg = oracle.PTINY
    # the coarse scan reads its early exit back: no graph on a card
    for cfg, impl in ((pcfg, "coarse"),
                      (pcfg.replace(sync_quorum=1), "pallas")):
        with pytest.raises(ValueError, match="'pallas' or 'xla'"):
            rx.make_serving_decoder(cfg, device="cuda", sync_impl=impl)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            rx.make_serving_decoder(pcfg, device="cuda")
    with pytest.raises(ValueError, match="input_format"):
        rx.make_serving_decoder(pcfg, device="cpu", input_format="iq")
    with pytest.raises(ValueError, match="stacks"):
        rx.make_serving_decoder(pcfg, device="cpu")(
            torch.zeros((2, 1000), dtype=torch.complex64))
    for entry in (lambda c: rx.make_serving_decoder(c, device="cpu"),
                  lambda c: rx.decode_all(np.zeros((2, 100), np.complex64),
                                          c, device="cpu")):
        with pytest.raises(TypeError):
            entry(oracle.TINY)


_BASE = dict(pid_max=12, bit_exact=False)
_SPEC = simulator.ChannelSpec(snr_db=30.0, delay=3000, seed=3)
# the paths chip_smoke.py serves from CUDA graphs, at 12 frames:
# (config, channel, decoder options)
SERVED_PATHS = {
    "operating_point": (ModemConfig(**_BASE), _SPEC,
                        dict(sync_impl="pallas")),
    "cfo_config": (ModemConfig(correct_cfo=True, sync_fallback=True,
                               smooth_channel=True, **_BASE),
                   simulator.ChannelSpec(snr_db=30.0, delay=3000, seed=3,
                                         cfo_subcarriers=0.05),
                   dict(sync_impl="pallas")),
    "mimo_2x2_zf_xla": (presets.mimo_2x2_zf(pid_max=12)[0],
                        presets.mimo_2x2_zf()[1],
                        dict(sync_impl="pallas", payload_impl="xla")),
    "track_channel": (ModemConfig(track_channel=True, track_block_frames=4,
                                  **_BASE), _SPEC,
                      dict(sync_impl="pallas")),
    "mimo_4x4_wideband": (presets.mimo_4x4_wideband(pid_max=12)[0],
                          presets.mimo_4x4_wideband()[1],
                          dict(sync_impl="xla")),
}


@pytest.mark.parametrize("path", list(SERVED_PATHS))
def test_served_paths_read_nothing_back(path):
    """After one warm-up decode (which fills the device-keyed caches), a
    decode of each served path dispatches no host read and no upload,
    and its serving decoder's result equals that decode."""
    cfg, spec, kw = SERVED_PATHS[path]
    cap, tx, _ = simulator.simulate_capture(cfg, spec, device="cpu")
    planes = (cap.real.contiguous(), cap.imag.contiguous())
    dec = rx.make_decoder(cfg, device="cpu", input_format="planes", **kw)
    dec(*planes)
    with HostReads() as spy:
        r = dec(*planes)
    assert spy.hits == []
    assert bool(r.synced)
    served = rx.make_serving_decoder(cfg, device="cpu", input_format="planes",
                                     **kw)(planes[0][None], planes[1][None])
    for f in oracle.INT_FIELDS:
        assert torch.equal(getattr(served, f)[0], getattr(r, f)), f
