"""Port parity of the payload stage: the read-zeros payload extraction,
the plain payload tail (held against the JAX Pallas kernel in interpret
mode and against the JAX XLA tail, all fed the same W and gain through
convert.from_jax_state), the kernel's gate, its input checks and its
build errors.  The CUDA kernel itself is held against the plain tail in
test_torch_cuda.py, which needs a GPU."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from rub_mimo_tpu.kernels.payload_fused import packed_perm
from rub_mimo_tpu.kernels.payload_fused import (
    payload_fused_strip as jax_payload_fused_strip)
from rub_mimo_tpu.pipeline import rx as jrx
from rub_mimo_tpu_torch import Modulation as PModulation
from rub_mimo_tpu_torch import convert
from rub_mimo_tpu_torch.kernels import _build
from rub_mimo_tpu_torch.kernels import payload_fused as pf
from rub_mimo_tpu_torch.ofdm import constellation
from rub_mimo_tpu_torch.pipeline import rx
import torch_oracle as oracle

# rx_sig agrees to rtol 1e-4; atol 1e-5 (of a unit-energy constellation)
# covers the few symbols near the origin, where float32 FFT rounding in
# another summation order is not small relative to the value itself
SIG_RTOL, SIG_ATOL = 1e-4, 1e-5


@pytest.fixture(scope="module")
def mid():
    """The MID capture, its JAX decode (XLA tail), the port's payload
    planes at JAX's offsets, and JAX's state carried over."""
    cfg = oracle.MID
    cap, tx = oracle.jax_capture(cfg, delay=3000)
    r = oracle.jax_decode(cap, cfg, payload_impl="xla")
    T, sym = cap.shape[-1], cfg.symbol_len
    cstart = min(max(int(r.sync_index), 0), T) + int(r.decode_start) - sym
    p = rx.extract_payload(oracle.t(cap), cstart, cfg.pid_max * sym)
    state = convert.from_jax_state(oracle.jax_state(r), "cpu")
    return cfg, r, p.real.contiguous(), p.imag.contiguous(), state


def _tail_args(cfg):
    return (constellation.table(oracle.pcfg(cfg).modulation),
            np.float32(1.0 / np.sqrt(cfg.M)))


def test_reference_tail_matches_jax_pallas_kernel(mid):
    cfg, r, p_re, p_im, st = mid
    tab, norm = _tail_args(cfg)
    n_sym, sym, cp = cfg.pid_max, cfg.symbol_len, cfg.cp_len
    sig, data = pf.payload_tail_reference(
        p_re, p_im, st["W"], st["normalize_gain"], tab, norm,
        n_sym=n_sym, symbol_len=sym, cp_len=cp)
    jsig, jdata = jax_payload_fused_strip(
        jnp.asarray(oracle.n(p_re)), jnp.asarray(oracle.n(p_im)), r.W,
        r.normalize_gain, tab, norm, n_sym=n_sym, symbol_len=sym,
        cp_len=cp, interpret=True)
    perm = packed_perm(cfg.M)  # packed order -> natural, pad frames off
    jsig = np.asarray(jsig)[:, :n_sym][:, :, perm]
    jdata = np.asarray(jdata)[:, :n_sym][:, :, perm]
    assert data.shape == (cfg.num_streams, n_sym, cfg.M)
    assert data.dtype == torch.int32
    np.testing.assert_array_equal(oracle.n(data), jdata)
    np.testing.assert_allclose(oracle.n(sig), jsig, rtol=SIG_RTOL,
                               atol=SIG_ATOL)


def test_reference_tail_matches_jax_xla_tail(mid):
    cfg, r, p_re, p_im, st = mid
    tab, norm = _tail_args(cfg)
    sig, data = pf.payload_tail_reference(
        p_re, p_im, st["W"], st["normalize_gain"], tab, norm,
        n_sym=cfg.pid_max, symbol_len=cfg.symbol_len, cp_len=cfg.cp_len)
    S = cfg.num_streams
    np.testing.assert_array_equal(oracle.n(data).reshape(S, -1),
                                  np.asarray(r.rx_data))
    np.testing.assert_allclose(oracle.n(sig).reshape(S, -1),
                               np.asarray(r.rx_sig), rtol=SIG_RTOL,
                               atol=SIG_ATOL)


def test_wrapper_takes_the_plain_tail_on_cpu_and_counts_nothing(mid):
    cfg, _, p_re, p_im, st = mid
    tab, norm = _tail_args(cfg)
    kw = dict(n_sym=cfg.pid_max, symbol_len=cfg.symbol_len,
              cp_len=cfg.cp_len)
    before = pf.payload_fused_strip.launches
    sig, data = pf.payload_fused_strip(p_re, p_im, st["W"],
                                       st["normalize_gain"], tab, norm, **kw)
    rsig, rdata = pf.payload_tail_reference(p_re, p_im, st["W"],
                                            st["normalize_gain"], tab, norm,
                                            **kw)
    assert torch.equal(sig, rsig) and torch.equal(data, rdata)
    assert pf.payload_fused_strip.launches == before
    none_sig, d2 = pf.payload_fused_strip(
        p_re, p_im, st["W"], st["normalize_gain"], tab, norm, emit_sig=False,
        **kw)
    assert none_sig is None and torch.equal(d2, data)


def test_from_jax_state_checks_its_input(mid):
    _, r, _, _, st = mid
    assert st["W"].dtype == torch.complex64
    assert st["ac_index"].dtype == torch.int64
    assert int(st["decode_start"]) == int(r.decode_start)
    with pytest.raises(KeyError):
        convert.from_jax_state({"bogus": np.zeros(3)}, "cpu")
    with pytest.raises(ValueError):
        convert.from_jax_state({"W": np.zeros((4, 2, 2), np.float32)}, "cpu")
    with pytest.raises(ValueError):
        convert.from_jax_state(
            {"W": np.zeros((8, 2, 2), np.complex64),
             "normalize_gain": np.zeros(4, np.float32)}, "cpu")


@pytest.mark.parametrize("offset", ["inside", "before", "past_end",
                                    "straddle_start", "straddle_end",
                                    "far_before"])
def test_extract_payload_read_zeros_matches_jax(offset):
    rng = np.random.default_rng(6)
    T, plen = 500, 120
    iq = (rng.standard_normal((2, T))
          + 1j * rng.standard_normal((2, T))).astype(np.complex64)
    cstart = {"inside": 40, "before": -plen, "past_end": T + 3,
              "straddle_start": -50, "straddle_end": T - 30,
              "far_before": -10 * plen}[offset]
    got = rx.extract_payload(oracle.t(iq), cstart, plen)
    for impl in ("xla", "xla_pad"):
        ref = jrx.extract_payload(jnp.asarray(iq), jnp.int32(cstart), plen,
                                  impl=impl)
        np.testing.assert_array_equal(oracle.n(got), np.asarray(ref))
    # a capture shorter than the span, and float planes
    short = oracle.t(iq.real[:, :50].copy())
    out = rx.extract_payload(short, -10, plen)
    assert torch.equal(out[:, 10:60], short) and not out[:, 60:].any()


def test_strip_supported_gate():
    assert pf.strip_supported(2048, 2, 32)
    assert pf.strip_supported(64, 4, 64)
    assert pf.strip_supported(4096, 1, 2)
    assert not pf.strip_supported(32, 2, 4)       # M below 64
    assert not pf.strip_supported(8192, 2, 4)     # M above 4096
    assert not pf.strip_supported(96, 2, 4)       # not a power of two
    assert not pf.strip_supported(2048, 5, 32)    # more than 4 streams
    assert not pf.strip_supported(2048, 2, 256)   # more than 64 points
    # the config gate: a guard-band allocation, another mode or detector,
    # tracking, or more points than the kernels take, go to the generic
    # tail (no raise)
    assert not rx.kernel_applicable(
        oracle.PMID.replace(use_all_carriers=False))
    rx.check_supported(oracle.PMID.replace(use_all_carriers=False))
    assert rx.kernel_applicable(oracle.PMID)
    assert rx.kernel_applicable(oracle.PTINY)
    assert not rx.kernel_applicable(
        oracle.PMID.replace(modulation=PModulation.QAM256))


def test_kernel_input_checks():
    S, M, cp, n_sym = 2, 64, 16, 3
    p = torch.zeros((S, n_sym * (M + cp)))
    W = torch.zeros((M, S, S), dtype=torch.complex64)
    g = torch.zeros(M)
    tab = constellation.table(PModulation.QPSK)
    pf._check(p, p, W, g, tab, n_sym, M + cp, cp)  # accepted
    bad = [
        (p.double(), p, W, g, tab),                      # dtype
        (p[:, :-1], p[:, :-1], W, g, tab),               # length
        (p, p, W[:32], g, tab),                          # W shape
        (p, p, W, g[:32], tab),                          # gain shape
        (p, p, W.transpose(1, 2), g, tab),               # not contiguous
        (p, p, W, g, np.zeros(65, np.complex64)),        # too many points
    ]
    for args in bad:
        with pytest.raises(ValueError):
            pf._check(*args, n_sym, M + cp, cp)
    kw = dict(n_sym=n_sym, symbol_len=M + cp, cp_len=cp)
    meta = [t.to("meta") for t in (p, p, W, g)]
    with pytest.raises(ValueError, match="no kernel"):
        pf.payload_fused_strip(*meta, tab, 1.0, **kw)  # neither CPU nor CUDA
    with pytest.raises(ValueError, match="several devices"):
        pf.payload_fused_strip(meta[0], p, W, g, tab, 1.0, **kw)


def test_build_is_keyed_by_source_and_raises_without_nvcc(monkeypatch,
                                                         tmp_path):
    path = _build.library_path("payload_fused_strip")
    assert path.parent == _build.BUILD_DIR and path.suffix == ".so"
    assert "sm_90a" in " ".join(_build.NVCC_FLAGS)
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    with pytest.raises(RuntimeError, match="nvcc"):
        _build._nvcc()
