"""Port parity of the halo exchange (K8's plain version) and the mesh
collectives: the port's ``ring_shift_right`` and
``parallel.collectives`` against the JAX package's ``ring_shift_right``
(Pallas interpret mode) and the lax collectives under shard_map, on the
virtual 8-CPU mesh, at the mesh shapes of tests/test_halo_dma.py.
Values must be equal.  The CUDA kernel itself is held against its plain
version in test_torch_cuda.py."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import PartitionSpec as P

from rub_mimo_tpu.kernels.halo_dma import ring_shift_right as jax_shift
from rub_mimo_tpu.parallel import mesh as jmesh
from rub_mimo_tpu_torch.kernels import halo_dma
from rub_mimo_tpu_torch.parallel import collectives as coll
from rub_mimo_tpu_torch.parallel import mesh as pmesh
import torch_oracle as oracle

SHAPES = [(2, 1), (4, 1), (8, 1), (4, 2)]
S, H = 2, 129


def _meshes(shape):
    n_time, n_sc = shape
    return (jmesh.make_mesh(n_time, n_sc),
            pmesh.make_mesh(n_time, n_sc, devices=["cpu"] * 8))


def _parts(x: np.ndarray, shape):
    """x [n_sc*S, n_time*H] -> parts[t][s], the block P("sc", "time")
    gives shard (t, s)."""
    n_time, n_sc = shape
    return [[oracle.t(x[s * S:(s + 1) * S, t * H:(t + 1) * H])
             for s in range(n_sc)] for t in range(n_time)]


def _assert_parts_equal(parts, jx: np.ndarray, shape):
    for t, row in enumerate(_parts(jx, shape)):
        for s, want in enumerate(row):
            np.testing.assert_array_equal(oracle.n(parts[t][s]),
                                          oracle.n(want), err_msg=f"{t},{s}")


def _complex(shape, seed=7):
    n_time, n_sc = shape
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((n_sc * S, n_time * H))
            + 1j * rng.standard_normal((n_sc * S, n_time * H))
            ).astype(np.complex64)


def _jax_run(mesh, fn, x, out_spec=P("sc", "time")):
    return np.asarray(jax.jit(jax.shard_map(
        fn, mesh=mesh, in_specs=P("sc", "time"), out_specs=out_spec))(
            jnp.asarray(x)))


@pytest.mark.parametrize("shape", SHAPES)
def test_ring_shift_matches_jax_kernel(shape):
    jm, pm = _meshes(shape)
    x = _complex(shape)
    want = _jax_run(jm, lambda loc: jax_shift(
        loc, axis_name="time", mesh_axes=tuple(jm.axis_names),
        n_dev=shape[0], interpret=True), x)
    got = halo_dma.ring_shift_right(_parts(x, shape), pm)
    _assert_parts_equal(got, want, shape)
    # the plain version is what the CPU wrapper ran, and the ppermute
    # collective moves the same halos
    _assert_parts_equal(halo_dma.ring_shift_right_reference(
        _parts(x, shape), pm), want, shape)
    _assert_parts_equal(coll.ppermute_right(_parts(x, shape), pm), want,
                        shape)


@pytest.mark.parametrize("shape", SHAPES)
def test_ppermute_left_matches_jax(shape):
    jm, pm = _meshes(shape)
    n_time = shape[0]
    x = _complex(shape, seed=8)
    want = _jax_run(jm, lambda loc: jax.lax.ppermute(
        loc, "time", [(j + 1, j) for j in range(n_time - 1)]), x)
    _assert_parts_equal(coll.ppermute_left(_parts(x, shape), pm), want,
                        shape)


# (port collective, its JAX counterpart, axes): sums, minima and maxima of
# small integers are exact in any order
REDUCTIONS = {
    "psum_time": (coll.psum, jax.lax.psum, "time"),
    "psum_both": (coll.psum, jax.lax.psum, ("time", "sc")),
    "pmin_time": (coll.pmin, jax.lax.pmin, "time"),
    "pmax_sc": (coll.pmax, jax.lax.pmax, "sc"),
}


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("op", sorted(REDUCTIONS))
def test_reductions_match_jax(shape, op):
    jm, pm = _meshes(shape)
    ours, theirs, axes = REDUCTIONS[op]
    n_time, n_sc = shape
    x = np.random.default_rng(9).integers(
        -1000, 1000, (n_sc * S, n_time * H)).astype(np.int32)
    want = _jax_run(jm, lambda loc: theirs(loc, axes), x)
    _assert_parts_equal(ours(_parts(x, shape), pm, axes), want, shape)


@pytest.mark.parametrize("shape", SHAPES)
def test_all_gather_matches_jax(shape):
    jm, pm = _meshes(shape)
    x = _complex(shape, seed=10)
    want = _jax_run(jm, lambda loc: jax.lax.all_gather(loc, "time"), x,
                    out_spec=P(None, "sc", "time"))
    got = coll.all_gather(_parts(x, shape), pm, "time")
    for i in range(shape[0]):
        _assert_parts_equal([[g[i] for g in row] for row in got], want[i],
                            shape)


def test_ring_shift_checks():
    pm = pmesh.make_mesh(2, 1, devices=["cpu"] * 2)
    x = torch.zeros((S, H), dtype=torch.complex64)
    with pytest.raises(ValueError, match="per-shard"):
        halo_dma.ring_shift_right([[x]], pm)
    meta = x.to("meta")
    with pytest.raises(ValueError, match="one device"):
        halo_dma.ring_shift_right([[x], [meta]], pm)
    with pytest.raises(ValueError, match="no kernel"):
        halo_dma.ring_shift_right([[meta], [meta]], pm)


def test_make_mesh_devices():
    m = pmesh.make_mesh(4, 2, devices=["cpu"] * 8)
    assert m.shape == {"time": 4, "sc": 2}
    assert m.axis_names == ("time", "sc") and m.home == torch.device("cpu")
    with pytest.raises(ValueError, match="needs 8 devices"):
        pmesh.make_mesh(4, 2, devices=["cpu"] * 4)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            pmesh.make_mesh()
