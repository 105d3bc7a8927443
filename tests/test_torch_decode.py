"""Port parity of the whole decode: rub_mimo_tpu_torch.pipeline.rx.decode
against rub_mimo_tpu.pipeline.rx.decode on the same capture (integers
equal, G within rtol 1e-4), the golden capture, scoring, the jax-free
import, and the no-fallback rule on CUDA."""

import os
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from rub_mimo_tpu.config import CommMode, Detector, ModemConfig
from rub_mimo_tpu.pipeline import report as jreport
from rub_mimo_tpu_torch.pipeline import report, rx
import torch_oracle as oracle

REPO = Path(__file__).resolve().parent.parent
GOLDEN = REPO / "tests" / "golden"

INT_FIELDS = oracle.INT_FIELDS

CASES = {
    "tiny": (oracle.TINY, dict()),
    "mid": (oracle.MID, dict(delay=3000)),
    "tiny_mmse": (oracle.TINY.replace(bit_exact=False,
                                      detector=Detector.MMSE), dict()),
}


@pytest.fixture(scope="module", params=list(CASES))
def decoded(request):
    cfg, cap_kw = CASES[request.param]
    cap, tx = oracle.jax_capture(cfg, **cap_kw)
    return cfg, cap, tx, oracle.jax_decode(cap, cfg), rx.decode(
        oracle.t(cap), oracle.pcfg(cfg))


def test_decode_matches_jax(decoded):
    cfg, _, _, ref, got = decoded
    assert bool(ref.synced)
    for f in INT_FIELDS:
        np.testing.assert_array_equal(oracle.n(getattr(got, f)),
                                      np.asarray(getattr(ref, f)), err_msg=f)
    np.testing.assert_allclose(oracle.n(got.G), np.asarray(ref.G),
                               rtol=1e-4, atol=1e-6)
    for f in ("W", "normalize_gain"):
        np.testing.assert_allclose(oracle.n(getattr(got, f)),
                                   np.asarray(getattr(ref, f)), rtol=1e-4,
                                   atol=1e-6, err_msg=f)
    np.testing.assert_allclose(oracle.n(got.rx_sig), np.asarray(ref.rx_sig),
                               rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(float(got.cfo_hat), float(ref.cfo_hat),
                               rtol=0, atol=1e-5)


def test_score_matches_jax(decoded):
    cfg, _, tx, ref, got = decoded
    ours = report.score(got, tx, oracle.pcfg(cfg))
    theirs = jreport.score(ref, tx, cfg)
    assert ours.synced == theirs.synced
    assert ours.frames_decoded == theirs.frames_decoded
    assert ours.valid_symbols == theirs.valid_symbols
    assert ours.symbol_error_rate == theirs.symbol_error_rate == [0.0, 0.0]
    assert ours.bit_error_rate == theirs.bit_error_rate
    np.testing.assert_allclose(ours.evm_percent, theirs.evm_percent,
                               rtol=1e-3)


def test_planes_and_complex_decoders_agree(decoded):
    cfg, cap, _, _, got = decoded
    pcfg = oracle.pcfg(cfg)
    planes = rx.make_decoder(pcfg, device="cpu", input_format="planes")(
        cap.real.copy(), cap.imag.copy())
    assert torch.equal(planes.rx_data, got.rx_data)
    assert torch.equal(planes.rx_sig, got.rx_sig)
    serving = rx.make_decoder(pcfg, device="cpu", keep_rx_sig=False)(cap)
    assert serving.rx_sig is None
    assert torch.equal(serving.rx_data, got.rx_data)


# the decode options of the acquisition front end, each alone at TINY:
# (config, capture options, decode options)
OPTION_CASES = {
    "cfo": (oracle.TINY.replace(correct_cfo=True),
            dict(cfo_subcarriers=0.05), dict()),
    "fallback_low_snr": (oracle.TINY.replace(sync_fallback=True),
                         dict(snr_db=8.0), dict()),
    "fallback_cfo_low_snr": (
        oracle.TINY.replace(sync_fallback=True, correct_cfo=True),
        dict(snr_db=8.0, cfo_subcarriers=0.05), dict()),
    "smooth": (oracle.TINY.replace(smooth_channel=True), dict(), dict()),
    "mmse_auto_noise": (oracle.TINY.replace(
        bit_exact=False, detector=Detector.MMSE, mmse_auto_noise=True),
        dict(), dict()),
    "keep_debug": (oracle.TINY, dict(), dict(keep_debug=True)),
    "sync_pallas": (oracle.TINY, dict(), dict(sync_impl="pallas")),
    "sync_xla": (oracle.TINY, dict(), dict(sync_impl="xla")),
}


@pytest.mark.parametrize("case", list(OPTION_CASES))
def test_decode_options_match_jax(case):
    cfg, cap_kw, kw = OPTION_CASES[case]
    cap, tx = oracle.jax_capture(cfg, **cap_kw)
    ref = oracle.jax_decode(cap, cfg, **kw)
    got = rx.make_decoder(oracle.pcfg(cfg), device="cpu", **kw)(cap)
    assert bool(ref.synced)
    oracle.assert_decode_matches_jax(got, ref)
    assert (got.metric is None) == (case != "keep_debug")
    if case.startswith("fallback"):
        # only the S0 cross-correlation acquires at this SNR
        assert not bool(rx.decode(oracle.t(cap), oracle.PTINY).synced)
    ser = report.score(got, tx, oracle.pcfg(cfg)).symbol_error_rate
    assert ser == jreport.score(ref, tx, cfg).symbol_error_rate
    if not case.startswith("fallback"):
        assert ser == [0.0, 0.0]


def _golden():
    import json

    from rub_mimo_tpu_torch import ModemConfig as PortConfig

    manifest = json.loads((GOLDEN / "manifest.json").read_text())
    cfg = PortConfig.from_json(json.dumps(manifest["config"]))
    chans = [np.fromfile(GOLDEN / f"rx{s + 1}.dat", dtype=np.complex64)
             for s in range(cfg.num_streams)]
    n = min(len(c) for c in chans)
    tx = np.stack([np.fromfile(GOLDEN / f"tx_data{s + 1}.dat",
                               dtype=np.uint32)
                   for s in range(cfg.num_streams)]).astype(np.int32)
    return cfg, np.stack([c[:n] for c in chans]), tx


def test_golden_capture_decodes_to_expected():
    cfg, cap, tx = _golden()
    r = rx.make_decoder(cfg, device="cpu")(cap)
    np.testing.assert_array_equal(oracle.n(r.rx_data),
                                  np.load(GOLDEN / "expected_rx_data.npy"))
    np.testing.assert_allclose(oracle.n(r.G),
                               np.load(GOLDEN / "expected_G.npy"),
                               rtol=1e-4, atol=1e-6)
    rep = report.score(r, tx, cfg)
    assert rep.synced and rep.symbol_error_rate == [0.0, 0.0]


@pytest.mark.parametrize("kw", [
    dict(track_channel=True), dict(use_all_carriers=False),
    dict(mode=CommMode.SISO), dict(detector=Detector.ML),
    dict(track_phase=True), dict(detector=Detector.SIC)])
def test_unported_options_raise(kw):
    """These options are ported now; what the decode still refuses is a
    JAX package config (TypeError, naming convert.config_from_jax), the
    TPU-only payload_impl "fused_packed", and unknown formats."""
    cfg = ModemConfig(**{**dict(num_subcarriers=64, cp_len=16,
                                num_access_codes=4, pid_max=8), **kw})
    with pytest.raises(TypeError, match="config_from_jax"):
        rx.make_decoder(cfg, device="cpu")
    with pytest.raises(TypeError, match="config_from_jax"):
        rx.decode(torch.zeros((2, 100), dtype=torch.complex64), cfg)
    rx.make_decoder(oracle.pcfg(cfg), device="cpu")
    with pytest.raises(ValueError, match="fused_packed"):
        rx.make_decoder(oracle.pcfg(cfg), device="cpu",
                        payload_impl="fused_packed")
    with pytest.raises(ValueError):
        rx.make_decoder(oracle.PTINY, device="cpu", input_format="bytes")


def test_cuda_decoder_raises_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        rx.make_decoder(oracle.PTINY, device="cuda")


def test_port_imports_no_jax():
    pattern = re.compile(r"^\s*(import|from)\s+(jax|jaxlib)\b", re.M)
    port_pattern = re.compile(
        r"^\s*(import|from)\s+rub_mimo_tpu(\.|\s|$)", re.M)
    files = sorted(f for f in (REPO / "rub_mimo_tpu_torch").rglob("*.py")
                   if "_build" not in f.parts)  # build outputs, not source
    files.append(REPO / "chip_smoke.py")
    for f in files:
        text = f.read_text()
        assert not pattern.search(text), f
        assert not port_pattern.search(text), f


def test_decode_runs_with_jax_unimportable():
    code = (
        "import sys\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['jaxlib'] = None\n"
        "sys.modules['rub_mimo_tpu'] = None\n"
        "import torch\n"
        "torch.set_num_threads(1)\n"
        "from rub_mimo_tpu_torch import tiny_config\n"
        "from rub_mimo_tpu_torch.io import simulator\n"
        "from rub_mimo_tpu_torch.pipeline import report, rx\n"
        "from rub_mimo_tpu_torch.ofdm import fec\n"
        "from rub_mimo_tpu_torch.estimate import sfo\n"
        "from rub_mimo_tpu_torch.utils import resample\n"
        "from rub_mimo_tpu_torch.apps import cli\n"
        "from rub_mimo_tpu_torch.io import capture, native\n"
        "from rub_mimo_tpu_torch.estimate import frontend\n"
        "from rub_mimo_tpu_torch.detect import precode\n"
        "from rub_mimo_tpu_torch.pipeline import artifacts, checkpoint\n"
        "from rub_mimo_tpu_torch.ofdm import liquid_tables\n"
        "from rub_mimo_tpu_torch.utils import profiling\n"
        "from rub_mimo_tpu_torch.apps import analyze, live_view, report_html\n"
        "from rub_mimo_tpu_torch.io import devices\n"
        "from rub_mimo_tpu_torch.parallel import multiprocess\n"
        "assert cli.main(['run', '--cpu', '--num_subcarriers', '64',\n"
        "                 '--cp_len', '16', '--num_access_codes', '4',\n"
        "                 '--frames', '8', '--modulation', 'qpsk',\n"
        "                 '--delay', '300', '--precoded', '-q']) == 0\n"
        "cfg = tiny_config(bit_exact=False)\n"
        "spec = simulator.ChannelSpec(snr_db=35.0, delay=300, seed=3)\n"
        "cap, tx, _ = simulator.simulate_capture(cfg, spec, device='cpu')\n"
        "r = rx.make_decoder(cfg, device='cpu')(cap)\n"
        "rep = report.score(r, tx, cfg)\n"
        "assert rep.synced and rep.symbol_error_rate == [0.0, 0.0], rep\n"
        "assert not any(m == 'jax' or m.startswith('jax.') for m, v in\n"
        "               sys.modules.items() if v is not None)\n"
        "assert not any(m.startswith('rub_mimo_tpu.') for m, v in\n"
        "               sys.modules.items() if v is not None)\n"
        "print('ok')\n"
    )
    env = dict(os.environ, PYTHONPATH=str(REPO))
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().endswith("ok")
