"""Port parity of the sharded decode (rub_mimo_tpu_torch.parallel) on CPU
meshes (``devices=["cpu"] * n``): against the JAX package's
build_sharded_decoder on the virtual 8-CPU mesh for each halo path, and
against the port's own single-device decode for the other mesh shapes
and every option tests/test_parallel.py covers; the coarse stage's seam
regressions of tests/test_sharded_coarse_sync.py; batched serving; and
K1's plain version with a symbol pitch against the JAX kernel with a
stride.  Integers and decisions must be equal, G within rtol 2e-4 /
atol 2e-5 (the tolerance of tests/test_parallel.py)."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from rub_mimo_tpu.config import CommMode, Detector, Modulation, tiny_config
from rub_mimo_tpu.kernels.payload_fused import packed_perm
from rub_mimo_tpu.kernels.payload_fused import (
    payload_fused_strip as jax_payload_fused_strip)
from rub_mimo_tpu.parallel import decode_sharded as jds
from rub_mimo_tpu.parallel import mesh as jmesh
from rub_mimo_tpu_torch.detect import zf
from rub_mimo_tpu_torch.kernels import payload_fused as pf
from rub_mimo_tpu_torch.ofdm import constellation
from rub_mimo_tpu_torch.parallel import decode_sharded as ds
from rub_mimo_tpu_torch.parallel import mesh as pmesh
from rub_mimo_tpu_torch.parallel import serving
from rub_mimo_tpu_torch.pipeline import rx
import torch_oracle as oracle

G_RTOL, G_ATOL = 2e-4, 2e-5
CPU8 = ["cpu"] * 8
BASE = tiny_config(bit_exact=False)


def _np(x):
    return oracle.n(x) if isinstance(x, torch.Tensor) else np.asarray(x)


def pmesh_of(shape):
    return pmesh.make_mesh(*shape, devices=CPU8)


def port_sharded(cap, cfg, shape, blocks=None, **kw):
    """The port's sharded decode of numpy capture cap on a CPU mesh."""
    m = pmesh_of(shape)
    if blocks is None:
        blocks = pmesh.shard_capture(oracle.t(cap), m)
    T = shape[0] * blocks[0][0].shape[1]
    return ds.build_sharded_decoder(oracle.pcfg(cfg), m, T, **kw)(blocks)


def port_single(cap, cfg):
    return rx.make_decoder(oracle.pcfg(cfg), device="cpu")(oracle.t(cap))


def assert_same(got, ref, cfo_tol=1e-5):
    """Sharded decode vs a reference decode of the same capture."""
    for f in ("synced", "sync_index", "sync_sample", "decode_start"):
        assert int(getattr(got, f)) == int(_np(getattr(ref, f))), f
    np.testing.assert_array_equal(_np(got.rx_data), _np(ref.rx_data))
    np.testing.assert_allclose(_np(got.G), _np(ref.G), rtol=G_RTOL,
                               atol=G_ATOL)
    assert abs(float(got.cfo_hat) - float(_np(ref.cfo_hat))) < cfo_tol


@pytest.fixture(scope="module")
def base_cap():
    return oracle.jax_capture(BASE, delay=501, seed=11)[0]


@pytest.mark.parametrize("halo_impl,shape", [
    ("ppermute", (2, 1)), ("ppermute", (4, 2)),
    ("pallas_dma", (2, 1)), ("pallas_dma", (4, 2))])
def test_matches_jax_sharded_decode(base_cap, halo_impl, shape):
    m = jmesh.make_mesh(*shape)
    iq = jmesh.shard_capture(jnp.asarray(base_cap), m)
    ref = jds.build_sharded_decoder(BASE, m, iq.shape[-1],
                                    halo_impl=halo_impl)(iq)
    got = port_sharded(base_cap, BASE, shape, halo_impl=halo_impl)
    assert bool(got.synced)
    assert_same(got, ref)
    np.testing.assert_allclose(_np(got.rx_sig), _np(ref.rx_sig), rtol=1e-4,
                               atol=1e-5)


@pytest.mark.parametrize("shape", [(4, 1), (2, 4), (1, 8)])
def test_matches_single_device_decode(base_cap, shape):
    got = port_sharded(base_cap, BASE, shape)
    assert bool(got.synced)
    assert_same(got, port_single(base_cap, BASE))


# option -> (JAX config, capture kwargs, mesh shape): the
# cases of tests/test_parallel.py, plus Alamouti and channel tracking
OPTIONS = {
    "mmse": (tiny_config(detector=Detector.MMSE, mmse_noise_var=1e-3,
                         bit_exact=False), dict(seed=4, delay=130), (4, 2)),
    "mmse_auto_noise": (tiny_config(bit_exact=False, detector=Detector.MMSE,
                                    mmse_auto_noise=True, mmse_noise_var=10.0),
                        dict(seed=4, delay=130), (4, 1)),
    "rx_diversity": (tiny_config(bit_exact=False, mode=CommMode.RX_DIVERSITY,
                                 siso_tx=0), dict(seed=4, delay=130), (4, 1)),
    "ml": (tiny_config(bit_exact=False, detector=Detector.ML,
                       mmse_noise_var=1e-3, pid_max=8),
           dict(seed=7, delay=222), (2, 4)),
    "sic": (tiny_config(bit_exact=False, detector=Detector.SIC,
                        mmse_noise_var=1e-3, pid_max=8),
            dict(seed=7, delay=222), (2, 4)),
    "cfo": (tiny_config(bit_exact=False, correct_cfo=True),
            dict(delay=256, seed=31, cfo_subcarriers=0.11), (4, 1)),
    "fallback": (tiny_config(bit_exact=False, sync_fallback=True),
                 dict(snr_db=10.0, delay=350, seed=13), (4, 1)),
    "fallback_cfo": (tiny_config(bit_exact=False, sync_fallback=True,
                                 correct_cfo=True),
                     dict(snr_db=12.0, delay=350, seed=13,
                          cfo_subcarriers=0.11), (4, 1)),
    "quorum": (tiny_config(bit_exact=False, num_streams=4, pid_max=4,
                           sync_quorum=3), dict(seed=23, delay=501), (4, 1)),
    "alamouti": (tiny_config(bit_exact=False, mode=CommMode.ALAMOUTI,
                             modulation=Modulation.QPSK),
                 dict(seed=5, delay=300), (4, 2)),
    "track_channel": (tiny_config(bit_exact=False, track_channel=True,
                                  track_block_frames=4),
                      dict(seed=5, delay=300), (4, 1)),
    "track_phase": (tiny_config(bit_exact=False, track_phase=True,
                                pid_max=16),
                    dict(delay=256, seed=31, cfo_subcarriers=0.004), (4, 1)),
}


@pytest.mark.parametrize("option", sorted(OPTIONS))
def test_options_match_single_device_decode(option):
    cfg, cap_kw, shape = OPTIONS[option]
    cap = oracle.jax_capture(cfg, **cap_kw)[0]
    ref = port_single(cap, cfg)
    assert bool(ref.synced)
    got = port_sharded(cap, cfg, shape)
    assert_same(got, ref, cfo_tol=1e-4)


def test_no_sync():
    rng = np.random.default_rng(0)
    noise = ((rng.standard_normal((2, BASE.window_len))
              + 1j * rng.standard_normal((2, BASE.window_len))) * 0.01
             ).astype(np.complex64)
    assert not bool(port_sharded(noise, BASE, (4, 1)).synced)


def test_planes_input_matches_complex(base_cap):
    m = pmesh_of((4, 2))
    blocks = pmesh.shard_capture(oracle.t(base_cap), m)
    T = 4 * blocks[0][0].shape[1]
    ref = ds.build_sharded_decoder(oracle.pcfg(BASE), m, T)(blocks)
    dec = ds.build_sharded_decoder(oracle.pcfg(BASE), m, T,
                                   input_format="planes")
    got = dec(*pmesh.shard_capture_planes(oracle.t(base_cap), m))
    assert bool(got.synced) and int(got.sync_index) == int(ref.sync_index)
    assert torch.equal(got.rx_data, ref.rx_data)
    assert torch.equal(got.rx_sig, ref.rx_sig)


def test_build_checks():
    pc = oracle.pcfg(BASE)
    m = pmesh_of((2, 1))
    with pytest.raises(TypeError, match="config_from_jax"):
        ds.build_sharded_decoder(BASE, m, 4096)
    for kw, msg in ((dict(halo_impl="dma"), "halo_impl"),
                    (dict(input_format="c64"), "input_format")):
        with pytest.raises(ValueError, match=msg):
            ds.build_sharded_decoder(pc, m, 4096, **kw)
    with pytest.raises(ValueError, match="multiple"):
        ds.build_sharded_decoder(pc, m, 4097)
    with pytest.raises(ValueError, match="symbol_len"):
        ds.build_sharded_decoder(pc, m, 2 * (pc.symbol_len - 1))
    two = pmesh.make_mesh(2, 1, devices=["cpu", "meta"])
    with pytest.raises(ValueError, match="one device"):
        ds.build_sharded_decoder(pc, two, 4096, halo_impl="pallas_dma")
    assert ds.coarse_left_halo(pc) == jds.coarse_left_halo(BASE)


def _padded(sim, T):
    cap = np.zeros((sim.shape[0], T), np.complex64)
    n = min(sim.shape[-1], T)
    cap[:, :n] = sim[:, :n]
    return cap


def test_shard_smaller_than_halo_takes_full_scan():
    """tests/test_sharded_coarse_sync.py:77: shards sized between the old
    coarse gate and the coarse stage's own left halo take the full-rate
    scan and match the offline decode."""
    from rub_mimo_tpu.sync import schmidl_cox as jsc

    cfg = tiny_config(pid_max=4, bit_exact=False)
    halo = ds.coarse_left_halo(oracle.pcfg(cfg))
    D = jsc._coarse_stride(cfg)
    old_gate = 2 * cfg.M + 4 * cfg.cp_len + 4 * D
    Tloc = ((old_gate + D - 1) // D + 1) * D
    assert old_gate <= Tloc < halo
    n_time = 8
    sim = oracle.jax_capture(cfg, snr_db=30.0, delay=300, seed=11)[0]
    cap = _padded(sim, n_time * Tloc)
    x = oracle.t(cap)
    blocks = [[x[:, t * Tloc:(t + 1) * Tloc].contiguous()]
              for t in range(n_time)]
    got = port_sharded(cap, cfg, (n_time, 1), blocks=blocks)
    ref = oracle.jax_decode(cap, cfg)
    assert bool(ref.synced) and bool(got.synced)
    assert_same(got, ref, cfo_tol=1e-4)
    assert_same(got, port_single(cap, cfg))


def test_fire_past_shard_boundary_matches_offline():
    """tests/test_sharded_coarse_sync.py:118: fires swept across a 2-way
    boundary, some past the shard end (the right halo), match the
    offline decode exactly."""
    from rub_mimo_tpu.sync import schmidl_cox as jsc

    cfg = tiny_config(pid_max=4, bit_exact=False)
    T, Tloc = 4096, 2048
    D = jsc._coarse_stride(cfg)

    def run(delay):
        sim = oracle.jax_capture(cfg, snr_db=30.0, delay=delay, seed=13)[0]
        cap = _padded(sim, T)
        return oracle.jax_decode(cap, cfg), port_sharded(cap, cfg, (2, 1)), \
            port_single(cap, cfg)

    t0 = int(run(400)[0].sync_sample)
    checked = crossed = 0
    for target in range(Tloc - 2 * D, Tloc + cfg.cp_len, 5):
        ref, got, single = run(400 + target - t0)
        if not bool(ref.synced):
            continue
        checked += 1
        crossed += int(ref.sync_sample) >= Tloc
        assert_same(got, ref, cfo_tol=1e-4)
        assert_same(got, single)
    assert checked >= 5 and crossed >= 1


def test_sharded_batch_serving_matches_single_device():
    cfg = tiny_config(bit_exact=False, pid_max=8)
    caps = [oracle.jax_capture(cfg, snr_db=30.0, delay=301 + 37 * i,
                               seed=100 + i)[0] for i in range(4)]
    T = max(c.shape[-1] for c in caps)
    batch = np.stack([_padded(c, T) for c in caps])
    m = pmesh_of((4, 1))
    got = serving.make_sharded_batch_decoder(oracle.pcfg(cfg), m)(
        serving.shard_batch(batch, m))
    assert got.rx_data.shape[0] == 4 and bool(got.synced.all())
    for i in range(4):
        ref = port_single(batch[i], cfg)
        for f in oracle.INT_FIELDS:
            np.testing.assert_array_equal(oracle.n(getattr(got, f)[i]),
                                          oracle.n(getattr(ref, f)), f)
    with pytest.raises(ValueError, match="multiple"):
        serving.shard_batch(batch[:3], m)


def test_strip_with_pitch_matches_jax_kernel():
    """K1's plain version with a symbol pitch of 2 * symbol_len (the
    sharded decode's stripe on a 2-wide "sc" axis) against the JAX
    kernel with that stride (interpret mode)."""
    cfg = oracle.MID
    S, M, cp, n_sym = cfg.num_streams, cfg.M, cfg.cp_len, 6
    pitch = 2 * cfg.symbol_len
    rng = np.random.default_rng(5)
    p = rng.standard_normal((2, S, n_sym * pitch)).astype(np.float32)
    G = ((rng.standard_normal((M, S, S)) + 1j * rng.standard_normal(
        (M, S, S))) / np.sqrt(2) + 2.0 * np.eye(S)).astype(np.complex64)
    W, gain = zf.invert(oracle.t(G))
    tab = constellation.table(oracle.pcfg(cfg).modulation)
    norm = np.float32(1.0 / np.sqrt(M))
    kw = dict(n_sym=n_sym, symbol_len=pitch, cp_len=cp)
    sig, data = pf.payload_fused_strip(oracle.t(p[0]), oracle.t(p[1]), W,
                                       gain, tab, norm, M=M, **kw)
    jsig, jdata = jax_payload_fused_strip(
        jnp.asarray(p[0]), jnp.asarray(p[1]), jnp.asarray(oracle.n(W)),
        jnp.asarray(oracle.n(gain)), tab, norm, interpret=True, **kw)
    perm = packed_perm(M)
    assert data.shape == (S, n_sym, M)
    np.testing.assert_array_equal(oracle.n(data),
                                  np.asarray(jdata)[:, :n_sym][:, :, perm])
    np.testing.assert_allclose(oracle.n(sig),
                               np.asarray(jsig)[:, :n_sym][:, :, perm],
                               rtol=1e-4, atol=1e-5)


def test_payload_stage_kernel_branch_matches_generic():
    """Stage C's K1 branch (the plain version on CPU) against its generic
    branch on every shard of a (2, 2) mesh: the same owned symbols, the
    same decisions and equalized symbols."""
    pc = oracle.PMID
    cap = oracle.jax_capture(oracle.MID, delay=3000)[0]
    ref = port_single(cap, oracle.MID)
    m = pmesh_of((2, 2))
    blocks = pmesh.shard_capture(oracle.t(cap), m)
    right = [[blocks[1][s][:, :pc.symbol_len] for s in range(2)],
             [torch.zeros_like(blocks[1][s][:, :pc.symbol_len])
              for s in range(2)]]
    pstart = int(ref.sync_index) - pc.symbol_len + int(ref.decode_start)
    owned = 0
    for t in range(2):
        for s in range(2):
            args = (blocks[t][s], right[t][s], t, s, pstart, pc, 2, ref.W,
                    ref.normalize_gain, ref.G)
            k, n, sig, data = ds._payload_stage(*args, fused=True)
            k2, n2, y, _ = ds._payload_stage(*args, fused=False)
            assert (k, n) == (k2, n2)
            owned += n
            if n:
                eq = y.transpose(0, 1)
                np.testing.assert_allclose(oracle.n(sig), oracle.n(eq),
                                           rtol=1e-4, atol=1e-5)
                assert torch.equal(data, constellation.demodulate(
                    eq, pc.modulation))
    assert owned == pc.pid_max


def test_sharded_decode_runs_with_jax_unimportable():
    """The parallel package and K8's wrapper import nothing of jax or the
    JAX package: a CPU-mesh sharded decode with both blocked."""
    import os
    import subprocess
    import sys
    from pathlib import Path

    code = (
        "import sys\n"
        "for m in ('jax', 'jaxlib', 'rub_mimo_tpu'):\n"
        "    sys.modules[m] = None\n"
        "import torch\n"
        "torch.set_num_threads(1)\n"
        "from rub_mimo_tpu_torch import tiny_config\n"
        "from rub_mimo_tpu_torch.io import simulator\n"
        "from rub_mimo_tpu_torch.kernels import halo_dma\n"
        "from rub_mimo_tpu_torch.parallel import decode_sharded, mesh, "
        "serving\n"
        "cfg = tiny_config(bit_exact=False)\n"
        "spec = simulator.ChannelSpec(snr_db=35.0, delay=300, seed=3)\n"
        "cap, tx, _ = simulator.simulate_capture(cfg, spec, device='cpu')\n"
        "m = mesh.make_mesh(2, 1, devices=['cpu'] * 2)\n"
        "b = mesh.shard_capture(cap, m)\n"
        "r = decode_sharded.build_sharded_decoder(\n"
        "    cfg, m, 2 * b[0][0].shape[1], halo_impl='pallas_dma')(b)\n"
        "assert bool(r.synced)\n"
        "assert not any(n == 'jax' or n.startswith(('jax.', 'rub_mimo_tpu.'))"
        " for n, v in sys.modules.items() if v is not None)\n"
        "print('ok')\n"
    )
    repo = Path(__file__).resolve().parents[1]
    out = subprocess.run([sys.executable, "-c", code], cwd=repo,
                         env=dict(os.environ, PYTHONPATH=str(repo)),
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().endswith("ok")
