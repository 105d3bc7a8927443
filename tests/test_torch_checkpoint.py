"""Port parity: checkpoints (pipeline/checkpoint.py) and the artifact
dump (pipeline/artifacts.py).

A checkpoint written by either package loads in the other with the same
keys, dtypes and values; resume_decode's decisions equal the JAX
package's and the decode's own; the artifact files' integer contents are
byte for byte the JAX package's, rx_sig within atol 1e-5, the S&C metric
within atol 1e-5 where it exceeds 0.5 and the matched-filter traces
within 1e-5 of their peak (the rule of torch_oracle.
assert_decode_matches_jax).
"""

import numpy as np
import pytest

import jax.numpy as jnp

from rub_mimo_tpu.config import CommMode, Modulation, tiny_config
from rub_mimo_tpu.pipeline import artifacts as jartifacts
from rub_mimo_tpu.pipeline import checkpoint as jcheckpoint
from rub_mimo_tpu_torch.pipeline import artifacts, checkpoint, rx
import torch_oracle as oracle

CASES = {
    "tiny": (tiny_config(bit_exact=False), dict()),
    "guard_bands": (tiny_config(bit_exact=False, use_all_carriers=False),
                    dict()),
    "alamouti": (tiny_config(bit_exact=False, mode=CommMode.ALAMOUTI),
                 dict()),
    "siso": (tiny_config(bit_exact=False, mode=CommMode.SISO), dict()),
    "cfo": (tiny_config(bit_exact=False, correct_cfo=True,
                        sync_fallback=True, modulation=Modulation.QAM16),
            dict(cfo_subcarriers=0.13)),
}


@pytest.fixture(scope="module", params=list(CASES))
def saved(request, tmp_path_factory):
    """(cfg, capture, JAX result, port result, JAX-written path,
    port-written path) for one case."""
    cfg, kw = CASES[request.param]
    cap, _ = oracle.jax_capture(cfg, **kw)
    ref = oracle.jax_decode(cap, cfg)
    got = rx.decode(oracle.t(cap), oracle.pcfg(cfg))
    assert bool(ref.synced) and bool(got.synced)
    d = tmp_path_factory.mktemp(request.param)
    jcheckpoint.save(d / "jax.npz", cfg, ref)
    checkpoint.save(d / "port.npz", oracle.pcfg(cfg), got)
    return cfg, cap, ref, got, d / "jax.npz", d / "port.npz"


def test_checkpoints_interchange(saved):
    """Same keys and dtypes; each package loads the other's file; the
    integer state is equal, the channel within rtol 1e-4."""
    cfg, _, _, _, jpath, ppath = saved
    with np.load(jpath) as a, np.load(ppath) as b:
        assert sorted(a.files) == sorted(b.files)
        for k in a.files:
            assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape, k
        assert bytes(a["config_json"]) == bytes(b["config_json"])
    ours = checkpoint.load(jpath)
    theirs = jcheckpoint.load(ppath)
    assert ours.config == oracle.pcfg(cfg) and theirs.config == cfg
    for k in ("synced", "sync_index", "decode_start"):
        assert getattr(ours, k) == getattr(theirs, k), k
    for k in ("plateau_start", "plateau_end", "ac_index", "rx_data",
              "symbol_valid"):
        np.testing.assert_array_equal(getattr(ours, k), getattr(theirs, k),
                                      err_msg=k)
    for k in ("G", "W", "normalize_gain"):
        np.testing.assert_allclose(getattr(ours, k), getattr(theirs, k),
                                   rtol=1e-4, atol=1e-6, err_msg=k)
    assert abs(ours.cfo_hat - theirs.cfo_hat) < 1e-5


@pytest.mark.parametrize("from_frame", [0, 4])
def test_resume_decode_matches_jax(saved, from_frame):
    """From the JAX-written checkpoint: the port's decisions equal the
    JAX resume's, rx_sig within atol 1e-4; from the port's own, they equal
    the decode's frames from from_frame on."""
    cfg, cap, _, got, jpath, ppath = saved
    sig, data = checkpoint.resume_decode(cap, checkpoint.load(jpath),
                                         from_frame, device="cpu")
    jsig, jdata = jcheckpoint.resume_decode(jnp.asarray(cap),
                                            jcheckpoint.load(jpath),
                                            from_frame)
    np.testing.assert_array_equal(oracle.n(data), np.asarray(jdata))
    np.testing.assert_allclose(oracle.n(sig), np.asarray(jsig), rtol=0,
                               atol=1e-4)
    _, own = checkpoint.resume_decode(cap, checkpoint.load(ppath),
                                      from_frame, device="cpu")
    skip = from_frame * oracle.pcfg(cfg).M_occupied
    np.testing.assert_array_equal(oracle.n(own),
                                  oracle.n(got.rx_data)[:, skip:])


def test_resume_decode_refuses():
    cfg = tiny_config(bit_exact=False, mode=CommMode.ALAMOUTI)
    ck = checkpoint.Checkpoint.__new__(checkpoint.Checkpoint)
    ck.config = oracle.pcfg(cfg)
    with pytest.raises(ValueError, match="even from_frame"):
        checkpoint.resume_decode(np.zeros((2, 10), np.complex64), ck, 3,
                                 device="cpu")
    with pytest.raises(TypeError, match="config_from_jax"):
        checkpoint.resume_decode(np.zeros((2, 10), np.complex64), ck, 0,
                                 cfg, device="cpu")


def test_artifacts_match_jax(tmp_path):
    cfg = tiny_config(bit_exact=False)
    cap, tx = oracle.jax_capture(cfg)
    ref = oracle.jax_decode(cap, cfg, keep_debug=True)
    got = rx.decode(oracle.t(cap), oracle.pcfg(cfg), keep_debug=True)
    jartifacts.dump(tmp_path / "jax", cfg, ref, iq=cap, tx_data=tx,
                    tx_sig=cap)
    artifacts.dump(tmp_path / "port", oracle.pcfg(cfg), got,
                   iq=oracle.t(cap), tx_data=tx, tx_sig=cap)
    names = sorted(p.name for p in (tmp_path / "jax").iterdir())
    assert names == sorted(p.name for p in (tmp_path / "port").iterdir())
    assert any(n.startswith("f_sc_") for n in names)
    assert any(n.startswith("corr_") for n in names)
    for name in names:
        a = (tmp_path / "port" / name).read_bytes()
        b = (tmp_path / "jax" / name).read_bytes()
        if name.startswith(("rx_data", "tx_data", "tx_sig", "rx1", "rx2")):
            assert a == b, name
            continue
        x, y = np.frombuffer(a, np.float32), np.frombuffer(b, np.float32)
        assert x.shape == y.shape, name
        if name.startswith("rx_sig"):
            np.testing.assert_allclose(x, y, rtol=0, atol=1e-5, err_msg=name)
        elif name.startswith("f_sc_"):
            near = y > 0.5
            assert near.any()
            np.testing.assert_allclose(x[near], y[near], rtol=0, atol=1e-5)
        else:
            np.testing.assert_allclose(x, y, rtol=0,
                                       atol=1e-5 * np.abs(y).max(),
                                       err_msg=name)
