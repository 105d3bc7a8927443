"""The port's sharded decode across processes
(rub_mimo_tpu_torch.parallel.multiprocess): 2 gloo ranks of 2 CPU shards
each, joined through a file store (no fixed port), on tiny_config's
(4, 1) and (2, 2) meshes at the JAX demo's channel (35 dB, delay 501,
seed 11) and one more seed.  Every rank's result must equal the
single-controller sharded decode and the JAX package's decode of the same
numpy capture (sync integers and decisions exactly, G within rtol 2e-4 /
atol 2e-5) and the other rank's; the ranks import no jax.  Refusals:
``pallas_dma`` on a multi-process CPU mesh, ``nccl`` without CUDA, a rank
that outlives its launch's timeout.  Without a group the mesh is what it
was."""

import numpy as np
import pytest
import torch

from rub_mimo_tpu.config import tiny_config
from rub_mimo_tpu_torch.io import simulator
from rub_mimo_tpu_torch.parallel import decode_sharded as ds
from rub_mimo_tpu_torch.parallel import mesh as pmesh
from rub_mimo_tpu_torch.parallel import multiprocess as mp
import torch_oracle as oracle

MESHES = ((4, 1), (2, 2))
SEEDS = (11, 29)
LAUNCH_TIMEOUT = 120.0  # each launch's own limit: a hung rank fails here
G_RTOL, G_ATOL = 2e-4, 2e-5
INT_FIELDS = ("synced", "sync_index", "sync_sample", "decode_start")


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """One launch: both ranks run every (mesh, seed) case, each writing
    its ShardedDecodeResult as .npz."""
    d = tmp_path_factory.mktemp("multiprocess")
    recs = mp.launch(2, 2, device="cpu", backend="gloo",
                     init_method=f"file://{d}/store", config="tiny",
                     meshes=MESHES, seeds=SEEDS, out_dir=str(d),
                     timeout=LAUNCH_TIMEOUT)
    return d, recs


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("shape", MESHES)
def test_every_rank_equals_single_controller_and_jax(runs, shape, seed):
    d, recs = runs
    cfg, spec = mp.config_case("tiny", seed)
    cap = simulator.simulate_capture(cfg, spec, device="cpu")[0]
    m = pmesh.make_mesh(*shape, devices=["cpu"] * 4)
    blocks = pmesh.shard_capture(cap, m)
    single = ds.build_sharded_decoder(
        cfg, m, shape[0] * blocks[0][0].shape[1])(blocks)
    jref = oracle.jax_decode(oracle.n(cap), tiny_config(bit_exact=False))
    assert bool(single.synced)
    ranks = [np.load(d / f"rank{r}_tiny_{seed}_{shape[0]}x{shape[1]}"
                         "_ppermute.npz") for r in range(2)]
    for got in ranks:
        for f in INT_FIELDS:
            assert int(got[f]) == int(getattr(single, f)), f
            assert int(got[f]) == int(np.asarray(getattr(jref, f))), f
        np.testing.assert_array_equal(got["rx_data"],
                                      oracle.n(single.rx_data))
        np.testing.assert_array_equal(got["rx_data"],
                                      np.asarray(jref.rx_data))
        np.testing.assert_allclose(got["G"], oracle.n(single.G),
                                   rtol=G_RTOL, atol=G_ATOL)
        np.testing.assert_allclose(got["G"], np.asarray(jref.G),
                                   rtol=G_RTOL, atol=G_ATOL)
    for f in ranks[0].files:  # every rank holds the same whole result
        np.testing.assert_array_equal(ranks[0][f], ranks[1][f], err_msg=f)
    mine = [r for r in recs if r["mesh"] == list(shape) and r["seed"] == seed]
    assert sorted(r["rank"] for r in mine) == [0, 1]
    for r in mine:
        assert r["equal_to_single"] and r["mismatches"] == 0
        assert r["ser_percent"] == [0.0, 0.0]
        assert not r["jax_loaded"]
    # each rank holds two whole time rows of the mesh, rank-major
    n_sc = shape[1]
    assert [r["local_shards"] for r in sorted(mine, key=lambda r: r["rank"])
            ] == [[[i // n_sc, i % n_sc] for i in range(2 * k, 2 * k + 2)]
                  for k in range(2)]


def test_pallas_dma_refused_on_a_multiprocess_cpu_mesh(tmp_path):
    """Shards of different ranks are never on one device: K8 has no
    route between CPU ranks, and pallas_dma is not turned into ppermute."""
    with pytest.raises(RuntimeError, match="ValueError: halo_impl="
                                           "'pallas_dma' needs"):
        mp.launch(2, 2, device="cpu", backend="gloo",
                  init_method=f"file://{tmp_path}/store",
                  halo_impl="pallas_dma", config="tiny", meshes=((4, 1),),
                  timeout=LAUNCH_TIMEOUT)


def test_a_rank_past_the_timeout_fails_the_launch(tmp_path):
    with pytest.raises(RuntimeError, match="still running after"):
        mp.launch(2, 2, device="cpu", backend="gloo",
                  init_method=f"file://{tmp_path}/store", config="tiny",
                  timeout=0.5)


def test_nccl_needs_cuda_and_backend_is_explicit(tmp_path):
    with pytest.raises(ValueError, match="backend"):
        pmesh.init_distributed(backend="mpi", num_processes=1, process_id=0,
                               init_method=f"file://{tmp_path}/store")
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="nccl"):
        pmesh.init_distributed(backend="nccl", num_processes=1,
                               process_id=0,
                               init_method=f"file://{tmp_path}/store")


def test_one_rank_group_from_the_environment(monkeypatch):
    """init_distributed with no address reads MASTER_ADDR / MASTER_PORT /
    RANK / WORLD_SIZE; a group of one rank leaves the mesh and the
    sharded decode as they are without a group."""
    import torch.distributed as dist

    monkeypatch.setenv("MASTER_ADDR", "127.0.0.1")
    monkeypatch.setenv("MASTER_PORT", str(mp.free_port()))
    monkeypatch.setenv("RANK", "0")
    monkeypatch.setenv("WORLD_SIZE", "1")
    pmesh.init_distributed(backend="gloo")
    try:
        assert dist.get_world_size() == 1 and dist.get_backend() == "gloo"
        m = pmesh.make_mesh(2, 1, devices=["cpu"] * 2)
        assert m.ranks is None and not m.spans_processes
        cfg, spec = mp.config_case("tiny", 11)
        cap = simulator.simulate_capture(cfg, spec, device="cpu")[0]
        blocks = pmesh.shard_capture(cap, m)
        got = ds.build_sharded_decoder(
            cfg, m, 2 * blocks[0][0].shape[1])(blocks)
    finally:
        dist.destroy_process_group()
    ref = ds.build_sharded_decoder(
        cfg, m, 2 * blocks[0][0].shape[1])(blocks)
    for f in got._fields:
        assert torch.equal(getattr(got, f), getattr(ref, f)), f
