"""Port parity of whole decodes at MID (M=2048, joint timing) with the sync
paths and the acquisition options: rub_mimo_tpu_torch's decode against
the JAX decode on the same capture (tests/torch_oracle.py::
assert_decode_matches_jax states the tolerances).  The same options at
TINY are in tests/test_torch_decode.py; the CFO config with smoothing and
the measured-noise MMSE at MID is in tests/test_torch_cfo.py."""

import pytest

from rub_mimo_tpu.pipeline import report as jreport
from rub_mimo_tpu_torch.pipeline import report, rx
import torch_oracle as oracle

# (config, capture options, decode options)
MID_CASES = {
    "keep_debug": (oracle.MID, dict(), dict(keep_debug=True)),
    "sync_pallas": (oracle.MID, dict(), dict(sync_impl="pallas")),
    "sync_xla": (oracle.MID, dict(), dict(sync_impl="xla")),
    # at 8 dB only the S0 cross-correlation acquires
    "fallback_cfo_low_snr": (
        oracle.MID.replace(sync_fallback=True, correct_cfo=True),
        dict(snr_db=8.0, cfo_subcarriers=0.05), dict()),
}


@pytest.mark.parametrize("case", list(MID_CASES))
def test_mid_decode_options_match_jax(case):
    cfg, cap_kw, kw = MID_CASES[case]
    cap, tx = oracle.jax_capture(cfg, delay=3000, **cap_kw)
    ref = oracle.jax_decode(cap, cfg, **kw)
    got = rx.make_decoder(oracle.pcfg(cfg), device="cpu", **kw)(cap)
    assert bool(ref.synced)
    oracle.assert_decode_matches_jax(got, ref)
    ser = report.score(got, tx, oracle.pcfg(cfg)).symbol_error_rate
    assert ser == jreport.score(ref, tx, cfg).symbol_error_rate
    if case.startswith("fallback"):
        assert not bool(rx.decode(oracle.t(cap), oracle.PMID).synced)
        assert abs(float(got.cfo_hat) - 0.05) < 1e-3
    else:
        assert ser == [0.0, 0.0]
