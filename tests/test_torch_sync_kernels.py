"""Port parity of the sync kernels' plain versions and of synchronize's
three impls.  K5's plain version (kernels.sc_sync.sc_sync_reference) is
held against the JAX one-pass kernel sc_sync_fused run in interpret mode,
K6's (kernels.sc_metric.sc_metric_reference) against the JAX Pallas
metric under the TPU interpret mode, as the JAX package's own tests run
them; synchronize(impl="coarse" | "xla" | "pallas", keep_metric) against
the JAX synchronize on TINY and MID.  Integers are equal; each float
tolerance is stated beside its check."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from rub_mimo_tpu.config import CommMode, Modulation, tiny_config
from rub_mimo_tpu.io import simulator as jsim
from rub_mimo_tpu.kernels.sc_sync import sc_sync_fused as jax_sc_sync_fused
from rub_mimo_tpu.sync import schmidl_cox as jsc
from rub_mimo_tpu_torch.kernels import sc_metric as k6
from rub_mimo_tpu_torch.kernels import sc_sync as k5
from rub_mimo_tpu_torch.sync import schmidl_cox
import torch_oracle as oracle

SYNC_CFG = tiny_config(bit_exact=False)
SISO_CFG = tiny_config(bit_exact=False, num_streams=1, mode=CommMode.SISO,
                       siso_tx=0, siso_rx=0, modulation=Modulation.QPSK,
                       plateau_threshold=0.5)


def _jax_capture(cfg, **kw):
    cap, _, _ = jsim.simulate_capture(cfg, jsim.ChannelSpec(**kw))
    return np.asarray(cap)


# the cases of tests/test_sc_sync_kernel.py: (cfg, capture, JAX block)
K5_CASES = {
    "d501_b512": lambda: (SYNC_CFG, _jax_capture(
        SYNC_CFG, snr_db=35.0, delay=501, seed=11), 512),
    "d130_b512": lambda: (SYNC_CFG, _jax_capture(
        SYNC_CFG, snr_db=30.0, delay=130, seed=11), 512),
    "d2000_b1024": lambda: (SYNC_CFG, _jax_capture(
        SYNC_CFG, snr_db=25.0, delay=2000, seed=11), 1024),
    "d64_b256": lambda: (SYNC_CFG, _jax_capture(
        SYNC_CFG, snr_db=35.0, delay=64, seed=11), 256),
    "noise_only": lambda: (SYNC_CFG, (0.01 * np.random.default_rng(0)
                                      .standard_normal((2, 4096, 2))
                                      .view(np.complex128)[..., 0])
                           .astype(np.complex64), 512),
    "single_stream": lambda: (SISO_CFG, _jax_capture(
        SISO_CFG, snr_db=30.0, delay=333, seed=5, identity=True), 512),
}


def _cfo(corr) -> float:
    return float(np.angle(np.sum(-np.asarray(corr))) / np.pi)


@pytest.mark.parametrize("case", list(K5_CASES))
def test_sc_sync_reference_matches_jax_kernel(case):
    cfg, cap, block = K5_CASES[case]()
    args = (cfg.M, cfg.cp_len, cfg.plateau_threshold)
    syn, t, starts, corr = jax_sc_sync_fused(jnp.asarray(cap), *args,
                                             block=block, interpret=True)
    before = k5.sc_sync_fused.launches
    got = k5.sc_sync_fused(oracle.t(cap), *args)  # CPU: the plain version
    assert k5.sc_sync_fused.launches == before
    assert got[0].dtype == torch.bool
    assert got[1].dtype == got[2].dtype == torch.int64
    assert got[3].dtype == torch.complex64
    assert got[3].shape == (cfg.num_streams,)
    assert bool(got[0]) == bool(syn) == (case != "noise_only")
    assert int(got[1]) == int(t)
    np.testing.assert_array_equal(oracle.n(got[2]), np.asarray(starts))
    # corr at t* from another chunking of the moving sums
    assert abs(_cfo(oracle.n(got[3])) - _cfo(corr)) < 1e-4


@pytest.mark.parametrize("T,block", [(1000, 64), (777, 128)])
def test_sc_metric_reference_matches_jax_pallas(T, block):
    from jax.experimental.pallas import tpu as pltpu

    from rub_mimo_tpu.kernels.sc_metric import sc_metric_pallas

    M = 32
    rng = np.random.default_rng(0)
    x = (rng.standard_normal((2, T))
         + 1j * rng.standard_normal((2, T))).astype(np.complex64)
    with pltpu.force_tpu_interpret_mode():
        ref = np.asarray(sc_metric_pallas(jnp.asarray(x), M, block=block))
    before = k6.sc_metric_fused.launches
    got = oracle.n(k6.sc_metric_fused(oracle.t(x), M, block=block))
    assert k6.sc_metric_fused.launches == before
    np.testing.assert_array_equal(got, oracle.n(
        k6.sc_metric_reference(oracle.t(x), M, block=block)))
    ok = np.isfinite(ref)
    assert ok.all()
    # the tolerance of tests/test_kernels.py (chunked cumsum rounding)
    np.testing.assert_allclose(got[ok], ref[ok], rtol=2e-3, atol=1e-4)


@pytest.fixture(scope="module", params=["tiny", "mid"])
def capture(request):
    cfg = {"tiny": oracle.TINY, "mid": oracle.MID}[request.param]
    cap, _ = oracle.jax_capture(cfg, delay=3000)
    return cfg, cap


@pytest.mark.parametrize("keep_metric", [False, True], ids=["", "metric"])
@pytest.mark.parametrize("impl", schmidl_cox.IMPLS)
def test_synchronize_impls_match_jax(capture, impl, keep_metric):
    cfg, cap = capture
    got = schmidl_cox.synchronize(oracle.t(cap), oracle.pcfg(cfg), impl=impl,
                                  keep_metric=keep_metric)
    ref = jsc.synchronize(jnp.asarray(cap), cfg, impl=impl,
                          keep_metric=keep_metric)
    assert bool(got.synced) and bool(ref.synced)
    for f in ("synced", "sync_sample", "sync_index", "plateau_start",
              "plateau_end"):
        np.testing.assert_array_equal(oracle.n(getattr(got, f)),
                                      np.asarray(getattr(ref, f)), err_msg=f)
    # corr at t* from other chunkings of the moving sums; the JAX kernel's
    # from its own
    tol = 1e-4 if impl == "pallas" else 1e-5
    assert abs(float(got.cfo_hat) - float(ref.cfo_hat)) < tol
    if ref.metric is None:
        assert got.metric is None
    else:
        m, jm = oracle.n(got.metric), np.asarray(ref.metric)
        assert m.shape == jm.shape and m.dtype == np.float32
        # noise-only windows are ratios of cancelled sums, rounded
        # differently by each package; the plateau rule reads the metric
        # only near its threshold
        near = jm > 0.5
        assert near.sum() > 50
        np.testing.assert_allclose(m[near], jm[near], rtol=0, atol=1e-5)


def test_synchronize_quorum_and_impl_names():
    cap, _ = oracle.jax_capture(oracle.TINY)
    x = oracle.t(cap)
    cfg = oracle.PTINY.replace(bit_exact=False, sync_quorum=1)
    before = k5.sc_sync_fused.launches
    quorum = schmidl_cox.synchronize(x, cfg, impl="pallas")  # -> coarse
    assert k5.sc_sync_fused.launches == before
    coarse = schmidl_cox.synchronize(x, cfg, impl="coarse")
    for a, b in zip(quorum, coarse):
        assert (a is None and b is None) or torch.equal(a, b)
    for bad in ("auto", "coarse128", "xla_pad"):
        with pytest.raises(ValueError, match="impl"):
            schmidl_cox.synchronize(x, oracle.PTINY, impl=bad)


def test_library_path_covers_the_shared_header(monkeypatch, tmp_path):
    """An edit to csrc/sc_common.cuh must rebuild K5 and K6 (no nvcc is
    needed to check: the path is the key)."""
    import shutil

    from rub_mimo_tpu_torch.kernels import _build

    csrc = tmp_path / "csrc"
    shutil.copytree(_build.CSRC, csrc)
    monkeypatch.setattr(_build, "CSRC", csrc)
    before = {n: _build.library_path(n) for n in ("sc_sync", "sc_metric")}
    header = csrc / "sc_common.cuh"
    header.write_text(header.read_text() + "\n// edited\n")
    after = {n: _build.library_path(n) for n in before}
    assert after["sc_sync"] != before["sc_sync"]
    assert after["sc_metric"] != before["sc_metric"]
    src = csrc / "sc_sync.cu"
    src.write_text(src.read_text() + "\n")
    assert _build.library_path("sc_sync") != after["sc_sync"]
    assert _build.library_path("sc_metric") == after["sc_metric"]
