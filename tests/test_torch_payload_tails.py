"""Port parity of the payload kernels of the generic tail and of the decode's
payload tails.  The plain versions of K7 (cp_strip), K4 (demap), K3
(eq_demap) and K2 (payload_fused) are held against the JAX Pallas kernels
in interpret mode, as the JAX package's own tests run them; whole decodes
under payload_impl "fused", "eqdemap" and "xla", with guard bands and with
CFO correction on the generic tail, against the JAX decode of the same
capture (tests/torch_oracle.py::assert_decode_matches_jax states the
tolerances).  The CUDA kernels themselves are held against these plain
versions in test_torch_cuda.py, which needs a GPU."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from rub_mimo_tpu.config import Detector, Modulation
from rub_mimo_tpu.kernels import cp_strip as jcp
from rub_mimo_tpu.kernels import eq_demap as jeq
from rub_mimo_tpu.kernels import payload_fused as jpf
from rub_mimo_tpu.pipeline import report as jreport
from rub_mimo_tpu_torch import CommMode as PCommMode
from rub_mimo_tpu_torch import Modulation as PModulation
from rub_mimo_tpu_torch.detect import zf
from rub_mimo_tpu_torch.kernels import cp_strip as k7
from rub_mimo_tpu_torch.kernels import eq_demap as k34
from rub_mimo_tpu_torch.kernels import payload_fused as pf
from rub_mimo_tpu_torch.ofdm import constellation
from rub_mimo_tpu_torch.pipeline import report, rx
import torch_oracle as oracle

# rx_sig to rtol 1e-4; atol 1e-5 (of a unit-energy constellation) covers
# the symbols near the origin, where float32 rounding in another
# summation order is not small relative to the value itself
SIG_RTOL, SIG_ATOL = 1e-4, 1e-5


def _complex(rng, shape):
    return (rng.standard_normal(shape)
            + 1j * rng.standard_normal(shape)).astype(np.complex64)


@pytest.mark.parametrize("dtype", ["c64", "f32"])
def test_cp_strip_reference_matches_jax_kernel(dtype):
    rng = np.random.default_rng(7)
    S, M, cp, n_sym = 2, 64, 16, 9
    x = _complex(rng, (S, n_sym * (M + cp) + 5))
    if dtype == "f32":
        x = x.real.copy()
    ref = np.asarray(jcp.cp_strip(jnp.asarray(x), n_sym, M + cp, cp,
                                  interpret=True))
    before = k7.cp_strip.launches
    got = k7.cp_strip(oracle.t(x), n_sym, M + cp, cp)  # CPU: the plain one
    assert k7.cp_strip.launches == before
    assert got.shape == (S, n_sym, M) and got.is_contiguous()
    np.testing.assert_array_equal(oracle.n(got), ref)
    np.testing.assert_array_equal(
        oracle.n(k7.cp_strip_reference(oracle.t(x), n_sym, M + cp, cp)), ref)


@pytest.mark.parametrize("m", [128, 256])
@pytest.mark.parametrize("mod", [Modulation.QAM16, Modulation.ARB32OPT])
def test_demap_matches_jax_kernel(m, mod):
    rng = np.random.default_rng(m)
    y = _complex(rng, (2, 6, m)) * np.float32(0.8)
    table = constellation.table(PModulation(mod.value))
    ref = np.asarray(jeq.demap(jnp.asarray(y), table, interpret=True))
    before = k34.demap.launches
    got = k34.demap(oracle.t(y), table)
    assert k34.demap.launches == before
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(oracle.n(got), ref)
    np.testing.assert_array_equal(oracle.n(constellation.demodulate(
        oracle.t(y), PModulation(mod.value))), ref)


def _eq_inputs(seed, M=512, n_sym=6):
    rng = np.random.default_rng(seed)
    x = _complex(rng, (2, n_sym, M))
    G = ((rng.standard_normal((M, 2, 2)) + 1j * rng.standard_normal(
        (M, 2, 2))) / np.sqrt(2) + 2.0 * np.eye(2)).astype(np.complex64)
    W, gain = zf.invert(oracle.t(G))
    return x, W, gain


def test_eq_demap_reference_matches_jax_kernel():
    x, W, gain = _eq_inputs(3)
    X = x * np.float32(1.0 / np.sqrt(x.shape[-1]))
    table = constellation.table(PModulation.ARB32OPT)
    jsig, jdata = jeq.eq_demap(jnp.asarray(X), jnp.asarray(oracle.n(W)),
                               jnp.asarray(oracle.n(gain)), table,
                               interpret=True)
    before = k34.eq_demap.launches
    sig, data = k34.eq_demap(oracle.t(X), W, gain, table)
    assert k34.eq_demap.launches == before
    assert data.shape == X.shape and data.dtype == torch.int32
    np.testing.assert_array_equal(oracle.n(data).reshape(2, -1),
                                  np.asarray(jdata))
    np.testing.assert_allclose(oracle.n(sig).reshape(2, -1),
                               np.asarray(jsig), rtol=SIG_RTOL,
                               atol=SIG_ATOL)
    none_sig, d2 = k34.eq_demap(oracle.t(X), W, gain, table, emit_sig=False)
    assert none_sig is None and torch.equal(d2, data)


def test_payload_fused_reference_matches_jax_kernel():
    x, W, gain = _eq_inputs(4)
    table = constellation.table(PModulation.ARB32OPT)
    norm = np.float32(1.0 / np.sqrt(x.shape[-1]))
    jsig, jdata = jpf.payload_fused(jnp.asarray(x), jnp.asarray(oracle.n(W)),
                                    jnp.asarray(oracle.n(gain)), table, norm,
                                    interpret=True)
    before = pf.payload_fused.launches
    sig, data = pf.payload_fused(oracle.t(x), W, gain, table, norm)
    assert pf.payload_fused.launches == before
    np.testing.assert_array_equal(oracle.n(data).reshape(2, -1),
                                  np.asarray(jdata))
    np.testing.assert_allclose(oracle.n(sig).reshape(2, -1),
                               np.asarray(jsig), rtol=SIG_RTOL,
                               atol=SIG_ATOL)


def test_kernel_gates():
    P = oracle.PMID
    for impl in ("auto", "fused_strip", "fused", "eqdemap"):
        assert rx.kernel_applicable(P, impl), impl
        for off in (dict(use_all_carriers=False),
                    dict(mode=PCommMode.SISO, num_streams=1, siso_tx=0,
                         siso_rx=0),
                    dict(mode=PCommMode.ALAMOUTI),
                    dict(detector=P.detector.SIC),
                    dict(detector=P.detector.ML),
                    dict(track_channel=True), dict(track_phase=True),
                    dict(modulation=PModulation.QAM256)):
            assert not rx.kernel_applicable(P.replace(**off), impl), off
    assert not rx.kernel_applicable(P, "xla")
    # K3 takes any M (the TPU kernel needed M % 128 == 0); K1 and K2 a
    # power of two in [64, 4096]
    odd = P.replace(num_subcarriers=8192, cp_len=576)
    assert rx.kernel_applicable(odd, "eqdemap")
    assert not rx.kernel_applicable(odd, "fused")
    assert not rx.kernel_applicable(odd, "auto")
    with pytest.raises(ValueError, match="fused_packed"):
        rx.check_supported(P, "fused_packed")


# (JAX config, capture options, payload_impl)
DECODE_CASES = {
    "mid_fused": (oracle.MID, dict(delay=3000), "fused"),
    "mid_eqdemap": (oracle.MID, dict(delay=3000), "eqdemap"),
    "mid_xla": (oracle.MID, dict(delay=3000), "xla"),
    "mid_mmse_xla": (oracle.MID.replace(detector=Detector.MMSE,
                                        mmse_noise_var=1e-3),
                     dict(delay=3000), "xla"),
    "tiny_guard_bands": (oracle.TINY.replace(use_all_carriers=False,
                                             normalize_rx_scale=True),
                         dict(), "auto"),
    "mid_guard_bands": (oracle.MID.replace(use_all_carriers=False,
                                           normalize_rx_scale=True),
                        dict(delay=3000), "auto"),
    "tiny_guard_unscaled": (oracle.TINY.replace(use_all_carriers=False,
                                                bit_exact=False),
                            dict(), "auto"),
    "tiny_cfo_generic": (oracle.TINY.replace(correct_cfo=True,
                                             use_all_carriers=False),
                         dict(cfo_subcarriers=0.05), "auto"),
    "tiny_cfo_eqdemap": (oracle.TINY.replace(correct_cfo=True),
                         dict(cfo_subcarriers=0.05), "eqdemap"),
    "tiny_cfo_fused": (oracle.TINY.replace(correct_cfo=True),
                       dict(cfo_subcarriers=0.05), "fused"),
}


@pytest.mark.parametrize("case", list(DECODE_CASES))
def test_payload_tail_decodes_match_jax(case):
    cfg, cap_kw, impl = DECODE_CASES[case]
    cap, tx = oracle.jax_capture(cfg, **cap_kw)
    ref = oracle.jax_decode(cap, cfg, payload_impl=impl)
    got = rx.make_decoder(oracle.pcfg(cfg), device="cpu",
                          payload_impl=impl)(cap)
    assert bool(ref.synced)
    oracle.assert_decode_matches_jax(got, ref)
    for f in ("W", "normalize_gain"):
        np.testing.assert_allclose(oracle.n(getattr(got, f)),
                                   np.asarray(getattr(ref, f)), rtol=1e-4,
                                   atol=1e-6, err_msg=f)
    # CFO cases: the residual ramp in float32 at another rounding
    atol = 1e-4 if cfg.correct_cfo else SIG_ATOL
    np.testing.assert_allclose(oracle.n(got.rx_sig), np.asarray(ref.rx_sig),
                               rtol=SIG_RTOL, atol=atol)
    assert got.rx_sig.shape == (cfg.num_streams,
                                cfg.pid_max * cfg.M_occupied)
    assert got.Y is None
    ser = report.score(got, tx, oracle.pcfg(cfg)).symbol_error_rate
    assert ser == jreport.score(ref, tx, cfg).symbol_error_rate
    if "unscaled" not in case:
        assert ser == [0.0, 0.0]
    serving = rx.make_decoder(oracle.pcfg(cfg), device="cpu",
                              payload_impl=impl, keep_rx_sig=False)(cap)
    assert serving.rx_sig is None
    assert torch.equal(serving.rx_data, got.rx_data)


def test_library_path_covers_the_payload_header(monkeypatch, tmp_path):
    """An edit to csrc/payload_common.cuh must rebuild K1, K2 and the
    K3/K4 library (no nvcc is needed to check: the path is the key)."""
    import shutil

    from rub_mimo_tpu_torch.kernels import _build

    csrc = tmp_path / "csrc"
    shutil.copytree(_build.CSRC, csrc)
    monkeypatch.setattr(_build, "CSRC", csrc)
    names = ("payload_fused_strip", "payload_fused", "eq_demap", "cp_strip")
    before = {n: _build.library_path(n) for n in names}
    header = csrc / "payload_common.cuh"
    header.write_text(header.read_text() + "\n// edited\n")
    for n in names:
        assert _build.library_path(n) != before[n], n
    for n in names:
        assert (csrc / f"{n}.cu").exists()
    assert '#include "payload_common.cuh"' in (
        csrc / "payload_fused.cu").read_text()
