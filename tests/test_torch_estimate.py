"""Port parity: the estimation region, the matched-filter search (joint
and per-code), the LS channel estimate and the ZF/MMSE weights.  Offsets
are equal to the JAX package's; G within rtol 1e-4, atol 1e-6."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from rub_mimo_tpu.config import Detector
from rub_mimo_tpu.detect import mmse as jmmse
from rub_mimo_tpu.detect import weights as jweights
from rub_mimo_tpu.detect import zf as jzf
from rub_mimo_tpu.estimate import ls as jls
from rub_mimo_tpu.pipeline import rx as jrx
from rub_mimo_tpu.sync import matched_filter as jmf
from rub_mimo_tpu_torch.detect import mmse, weights, zf
from rub_mimo_tpu_torch.estimate import ls
from rub_mimo_tpu_torch.pipeline import rx
from rub_mimo_tpu_torch.sync import matched_filter
import torch_oracle as oracle


@pytest.fixture(scope="module", params=["tiny", "mid"])
def case(request):
    """(cfg, JAX decode result, JAX region, port region)."""
    cfg = {"tiny": oracle.TINY, "mid": oracle.MID}[request.param]
    cap, _ = oracle.jax_capture(cfg, delay=3000 if cfg.M > 64 else 300)
    r = oracle.jax_decode(cap, cfg)
    assert bool(r.synced)
    si = int(r.sync_index)
    jregion = np.asarray(jrx._extract_region(jnp.asarray(cap),
                                             r.sync_index, cfg))
    return cfg, r, jregion, rx._extract_region(oracle.t(cap), si, cfg)


def test_region_equal(case):
    _, _, jregion, region = case
    np.testing.assert_array_equal(oracle.n(region), jregion)


@pytest.mark.parametrize("joint", [False, True])
def test_matched_filter_matches_jax(case, joint):
    cfg, _, jregion, region = case
    got = matched_filter.search(region, cfg, joint=joint)
    ref = jmf.search(jnp.asarray(jregion), cfg, joint=joint)
    np.testing.assert_array_equal(oracle.n(got.s0_index),
                                  np.asarray(ref.s0_index))
    np.testing.assert_array_equal(oracle.n(got.ac_index),
                                  np.asarray(ref.ac_index))
    np.testing.assert_allclose(oracle.n(got.ac_peak), np.asarray(ref.ac_peak),
                               rtol=1e-4, atol=1e-7)
    np.testing.assert_array_equal(matched_filter.templates(cfg),
                                  jmf.templates(cfg))


def test_decode_offsets_and_channel_match_jax(case):
    cfg, r, _, region = case
    joint = (not cfg.bit_exact) and cfg.timing_mode == "joint"
    mf = matched_filter.search(region, cfg, joint=joint)
    np.testing.assert_array_equal(oracle.n(mf.s0_index),
                                  np.asarray(r.s0_index))
    np.testing.assert_array_equal(oracle.n(mf.ac_index),
                                  np.asarray(r.ac_index))
    G = ls.estimate_channel(region, mf.ac_index, cfg)
    np.testing.assert_allclose(oracle.n(G), np.asarray(r.G), rtol=1e-4,
                               atol=1e-6)


@pytest.mark.parametrize("bit_exact", [False, True])
def test_ls_uniform_and_gathered_paths_match_jax(case, bit_exact):
    """The port's gathered windows against both of the JAX package's LS
    paths: its uniform strided span (on the joint-timing grid the decode
    produced) and its per-window gather."""
    cfg0, r, jregion, region = case
    cfg = cfg0.replace(bit_exact=bit_exact)
    ac = np.asarray(r.ac_index)
    joint = (not cfg0.bit_exact) and cfg0.timing_mode == "joint"
    got = ls.estimate_channel(region, oracle.t(ac), cfg)
    for uni in {False, joint}:
        ref = jls.estimate_channel(jnp.asarray(jregion), jnp.asarray(ac),
                                   cfg, uniform=uni)
        np.testing.assert_allclose(oracle.n(got), np.asarray(ref),
                                   rtol=1e-4, atol=1e-6)


def test_code_ffts_clamps_out_of_range_offsets_like_jax(case):
    """Offsets off the joint grid, before the window and past its end are
    clamped to [0, W - M], as the JAX package's gathered windows are."""
    cfg, r, jregion, region = case
    ac = np.asarray(r.ac_index).copy()
    ac[0, 1] += 1
    ac[0, 0] = -5
    ac[-1, -1] = region.shape[-1]
    offs = ls.ac_offsets(oracle.t(ac), cfg)
    got = ls.code_ffts(region, offs, cfg)
    ref = jls.code_ffts(jnp.asarray(jregion), oracle.n(offs), cfg,
                        uniform=False)
    np.testing.assert_allclose(oracle.n(got), np.asarray(ref), rtol=1e-4,
                               atol=1e-4 * float(np.abs(ref).max()))


@pytest.mark.parametrize("N", [2, 3, 4])
@pytest.mark.parametrize("unity", [False, True])
def test_zf_invert_and_equalize_match_jax(N, unity):
    rng = np.random.default_rng(N)
    G = ((rng.standard_normal((64, N, N)) + 1j * rng.standard_normal(
        (64, N, N))) + 2 * np.eye(N)).astype(np.complex64)
    W, g = zf.invert(oracle.t(G), unity)
    jW, jg = jzf.invert(jnp.asarray(G), unity)
    np.testing.assert_allclose(oracle.n(W), np.asarray(jW), rtol=1e-4,
                               atol=1e-5)
    np.testing.assert_allclose(oracle.n(g), np.asarray(jg), rtol=1e-4)
    Y = (rng.standard_normal((5, N, 64))
         + 1j * rng.standard_normal((5, N, 64))).astype(np.complex64)
    eq = zf.equalize(oracle.t(Y), W, g)
    jeq = jzf.equalize(jnp.asarray(Y), jW, jg)
    np.testing.assert_allclose(oracle.n(eq), np.asarray(jeq), rtol=1e-4,
                               atol=1e-4)


def test_mmse_and_weight_selection_match_jax(case):
    cfg, r, _, _ = case
    G = np.asarray(r.G)
    W, g = mmse.mmse_weights(oracle.t(G), 0.05)
    jW, jg = jmmse.mmse_weights(jnp.asarray(G), 0.05)
    np.testing.assert_allclose(oracle.n(W), np.asarray(jW), rtol=1e-4,
                               atol=1e-5)
    np.testing.assert_array_equal(oracle.n(g), np.asarray(jg))
    for det in (Detector.ZF, Detector.MMSE):
        c = cfg.replace(detector=det)
        W, g = weights.weights_for(c, oracle.t(G))
        jW, jg = jweights.weights_for(c, jnp.asarray(G), jnp.asarray(G))
        np.testing.assert_allclose(oracle.n(W), np.asarray(jW), rtol=1e-4,
                                   atol=1e-5)
        np.testing.assert_allclose(oracle.n(g), np.asarray(jg), rtol=1e-5)
    with pytest.raises(NotImplementedError):
        weights.weights_for(cfg.replace(detector=Detector.SIC), oracle.t(G))
