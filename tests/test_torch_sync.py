"""Port parity: moving sums, the Schmidl&Cox metric and plateau scan, and
the coarse sync with its prefix early exit.  Integer results (synced,
t*, sync_index, run starts) are equal to the JAX package's; cfo_hat is
within 1e-5."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from rub_mimo_tpu.sync import schmidl_cox as jsc
from rub_mimo_tpu.utils import movsum as jmov
from rub_mimo_tpu_torch.sync import schmidl_cox
from rub_mimo_tpu_torch.utils import movsum
import torch_oracle as oracle


@pytest.mark.parametrize("complex_", [False, True])
def test_moving_sum_and_delay_match_jax(complex_):
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 1000)).astype(np.float32)
    if complex_:
        x = (x + 1j * rng.standard_normal((2, 1000))).astype(np.complex64)
    for w, block in ((32, 64), (32, 1 << 15), (100, 128)):
        got = oracle.n(movsum.moving_sum(oracle.t(x), w, block=block))
        ref = np.asarray(jmov.moving_sum(jnp.asarray(x), w, block=block))
        np.testing.assert_allclose(got, ref, rtol=0, atol=1e-5)
    np.testing.assert_array_equal(oracle.n(movsum.delay(oracle.t(x), 7)),
                                  np.asarray(jmov.delay(jnp.asarray(x), 7)))


def test_sc_metric_and_plateau_scan_match_jax():
    cap, _ = oracle.jax_capture(oracle.TINY)
    m, c = schmidl_cox.sc_metric(oracle.t(cap), oracle.PTINY.M)
    jm, jc = jsc.sc_metric(jnp.asarray(cap), oracle.TINY.M)
    np.testing.assert_allclose(oracle.n(c), np.asarray(jc), rtol=0,
                               atol=1e-5)
    # where the window holds only noise the metric is a ratio of two
    # cumsum differences with heavy cancellation, rounded differently by
    # each package; the plateau rule reads it only near the threshold
    near = np.asarray(jm) > 0.5
    assert near.sum() > 50
    np.testing.assert_allclose(oracle.n(m)[near], np.asarray(jm)[near],
                               rtol=0, atol=1e-5)
    # the plateau scan on one metric array is integer-exact
    rng = np.random.default_rng(2)
    metric = rng.uniform(0.9, 1.0, size=(3, 400)).astype(np.float32)
    metric[:, 150:260] = 0.99
    for quorum in (None, 2):
        got = schmidl_cox.plateau_scan(oracle.t(metric), 16, 0.95, quorum)
        ref = jsc.plateau_scan(jnp.asarray(metric), 16, 0.95, quorum)
        for a, b in zip(got, ref):
            np.testing.assert_array_equal(oracle.n(a), np.asarray(b))


def _assert_sync_equal(got, ref):
    assert bool(got.synced) == bool(ref.synced)
    assert int(got.sync_sample) == int(ref.sync_sample)
    assert int(got.sync_index) == int(ref.sync_index)
    np.testing.assert_array_equal(oracle.n(got.plateau_start),
                                  np.asarray(ref.plateau_start))
    np.testing.assert_array_equal(oracle.n(got.plateau_end),
                                  np.asarray(ref.plateau_end))
    np.testing.assert_allclose(float(got.cfo_hat), float(ref.cfo_hat),
                               rtol=0, atol=1e-5)


# (case, capture builder): a short capture (coarse scan, no prefix), a
# fire inside the 2**18-sample prefix, a fire past it (the whole-capture
# coarse scan), and noise only
CASES = {
    "short": lambda: oracle.jax_capture(oracle.TINY)[0],
    "in_prefix": lambda: oracle.jax_capture(
        oracle.TINY, delay=1000, trailing=270000)[0],
    "past_prefix": lambda: oracle.jax_capture(
        oracle.TINY, delay=270000, trailing=500)[0],
    "noise_only": lambda: (np.random.default_rng(8).standard_normal(
        (2, 6000, 2)).astype(np.float32).view(np.complex64)[..., 0]),
}


@pytest.mark.parametrize("case", list(CASES))
def test_synchronize_matches_jax_coarse(case):
    cap = CASES[case]()
    got = schmidl_cox.synchronize(oracle.t(cap), oracle.PTINY)
    ref = jsc.synchronize(jnp.asarray(cap), oracle.TINY, impl="coarse")
    _assert_sync_equal(got, ref)
    assert bool(got.synced) == (case != "noise_only")


def test_full_scan_and_quorum_match_jax():
    cap, _ = oracle.jax_capture(oracle.TINY)
    x = oracle.t(cap)
    _assert_sync_equal(
        schmidl_cox._synchronize_full(x, oracle.PTINY, 1 << 15),
        jsc.synchronize(jnp.asarray(cap), oracle.TINY, impl="xla"))
    cfg = oracle.TINY.replace(bit_exact=False, sync_quorum=1)
    _assert_sync_equal(schmidl_cox.synchronize(x, oracle.pcfg(cfg)),
                       jsc.synchronize(jnp.asarray(cap), cfg, impl="coarse"))
