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
from rub_mimo_tpu_torch.detect import zf
from rub_mimo_tpu_torch.io import simulator
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


# K1's window at a start in a capture of T = 3 plen samples: inside at
# each alignment mod 4, before it, across its end and wholly past it
_WIN_M, _WIN_CP, _WIN_NSYM = 64, 16, 6
_WIN_PLEN = _WIN_NSYM * (_WIN_M + _WIN_CP)
_WIN_T = 3 * _WIN_PLEN
WINDOW_STARTS = {"inside_mod0": 40, "inside_mod1": 41, "inside_mod2": 42,
                 "inside_mod3": 43, "negative": -150,
                 "across_end": _WIN_T - _WIN_PLEN // 2,
                 "past_end": _WIN_T + 5}


@pytest.mark.parametrize("where", list(WINDOW_STARTS))
def test_windowed_tail_equals_gather_then_compact(where):
    """K1 given a capture's planes and a device start (its plain version
    here) equals the decode's former path, the window gathered with
    gather_window and then the compact call, bit for bit."""
    S, M, cp, n_sym = 2, _WIN_M, _WIN_CP, _WIN_NSYM
    re, im, G = oracle.random_tail_inputs(22, S, M, cp, 3 * n_sym)
    planes = (torch.as_tensor(re), torch.as_tensor(im))
    assert planes[0].shape == (S, _WIN_T)
    W, gain = zf.invert(torch.as_tensor(G))
    tab = constellation.table(PModulation.QAM16)
    norm = np.float32(1.0 / np.sqrt(M))
    kw = dict(n_sym=n_sym, symbol_len=M + cp, cp_len=cp)
    start = torch.tensor(WINDOW_STARTS[where], dtype=torch.int64)
    counts = (pf.payload_fused_strip.launches,
              pf.payload_fused_strip.windowed)
    sig, data = pf.payload_fused_strip(*planes, W, gain, tab, norm,
                                       start=start, **kw)
    win = rx.window_index(start, _WIN_PLEN, _WIN_T, torch.device("cpu"))
    compact = [rx.gather_window(p, win) for p in planes]
    want_sig, want_data = pf.payload_fused_strip(*compact, W, gain, tab,
                                                 norm, **kw)
    assert torch.equal(sig, want_sig) and torch.equal(data, want_data)
    assert (pf.payload_fused_strip.launches,
            pf.payload_fused_strip.windowed) == counts  # CPU: none


@pytest.mark.parametrize("cut,late", [(0, 0), (3, 0), (0, 1)],
                         ids=["whole", "window_past_end", "one_sample_late"])
def test_decode_on_planes_reads_the_window_from_the_capture(cut, late,
                                                            monkeypatch):
    """decode() on planes hands K1 the capture and the window's start;
    its rx_sig and rx_data equal the gathered window's compact tail and
    the decode of the same capture as complex input, bit for bit (with
    ``cut`` symbols of the payload cut off the capture's end, the window
    reaches past it).  The start is the one ``rx.window_index`` places:
    moved ``late`` samples there (the fault the benchmark's check plants
    that way), both decodes read the later window."""
    cfg = oracle.PMID
    spec = simulator.ChannelSpec(snr_db=30.0, delay=2000, seed=5)
    cap = simulator.simulate_capture(cfg, spec, device="cpu")[0]
    sym = cfg.symbol_len
    if cut:
        cap = cap[:, :2000 + cap.shape[-1] // 2 + 4 * sym].contiguous()
    planes = (cap.real.contiguous(), cap.imag.contiguous())
    T, plen = cap.shape[-1], cfg.pid_max * sym
    real = rx.window_index
    monkeypatch.setattr(rx, "window_index", lambda start, n, *a: real(
        start + late if n == plen else start, n, *a))
    r = rx.decode(planes, cfg, sync_impl="pallas")
    assert bool(r.synced)
    cstart = torch.clamp(r.sync_index, 0, T) + r.decode_start - sym + late
    if cut:
        assert int(cstart) + plen > T
    win = real(cstart, plen, T, torch.device("cpu"))
    sig, data = pf.payload_fused_strip(
        *(rx.gather_window(p, win) for p in planes), r.W, r.normalize_gain,
        constellation.table(cfg.modulation),
        np.float32(1.0 / np.sqrt(cfg.M_occupied)), n_sym=cfg.pid_max,
        symbol_len=sym, cp_len=cfg.cp_len)
    S = cfg.num_streams
    assert torch.equal(r.rx_sig, sig.reshape(S, -1))
    assert torch.equal(r.rx_data, data.reshape(S, -1))
    c = rx.decode(cap, cfg, sync_impl="pallas")
    assert torch.equal(r.rx_sig, c.rx_sig)
    assert torch.equal(r.rx_data, c.rx_data)


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
    # a capture's planes of any length at a one-element int64 start
    cap = torch.zeros((S, 1000))
    pf._check(cap, cap, W, g, tab, n_sym, M + cp, cp,
              start=torch.tensor(-7))
    for start in (3, torch.tensor(3, dtype=torch.int32),
                  torch.tensor([1, 2]), torch.tensor(3).to("meta")):
        with pytest.raises(ValueError, match="start"):
            pf._check(cap, cap, W, g, tab, n_sym, M + cp, cp, start=start)
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
