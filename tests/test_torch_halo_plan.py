"""K8's launch plan across cards, on the CPU: which destination shards go
in which card's launch, which (card, peer) pairs need peer access, and
the launch counts of the meshes the sharded decode runs, over 1, 2 and
4 cards.  The plan is a pure function of torch.device objects, so no
card is needed: the meshes are built from numpy grids of
``torch.device("cuda", i)`` (``make_mesh`` refuses absent cards).  The
kernel itself is held against its plain version on the cards in
test_torch_cuda.py."""

import numpy as np
import pytest
import torch

from rub_mimo_tpu_torch import ModemConfig
from rub_mimo_tpu_torch.kernels import halo_dma
from rub_mimo_tpu_torch.parallel import decode_sharded as ds
from rub_mimo_tpu_torch.parallel.mesh import Mesh


def cuda(i: int) -> torch.device:
    return torch.device("cuda", i)


def cycling_mesh(shape, cards: int) -> Mesh:
    """A mesh whose shard i (time-major) sits on card i % cards."""
    n_time, n_sc = shape
    grid = np.empty(shape, dtype=object)
    for i in range(n_time * n_sc):
        grid[i // n_sc, i % n_sc] = cuda(i % cards)
    return Mesh(grid)


# (mesh shape, cards) -> (launches, peer pairs as (destination, source)
# card indices in time-major order of first appearance)
PLANS = {
    ((2, 1), 1): (1, []),
    ((4, 1), 1): (1, []),
    ((2, 2), 1): (1, []),
    ((4, 2), 1): (1, []),
    ((2, 1), 2): (2, [(1, 0)]),
    ((4, 1), 2): (2, [(1, 0), (0, 1)]),
    ((2, 2), 2): (2, []),                 # each "sc" column on one card
    ((4, 2), 2): (2, []),
    ((2, 1), 4): (2, [(1, 0)]),
    ((4, 1), 4): (4, [(1, 0), (2, 1), (3, 2)]),
    ((2, 2), 4): (4, [(2, 0), (3, 1)]),
    ((4, 2), 4): (4, [(2, 0), (3, 1), (0, 2), (1, 3)]),
}


@pytest.mark.parametrize("shape,cards", list(PLANS),
                         ids=[f"{s[0]}x{s[1]}_on_{c}" for s, c in PLANS])
def test_launches_and_peer_pairs(shape, cards):
    launches, pairs = PLANS[shape, cards]
    m = cycling_mesh(shape, cards)
    assert len(halo_dma.plan_launches(m.devices)) == launches
    assert halo_dma.peer_pairs(m.devices) == [(cuda(d), cuda(s))
                                              for d, s in pairs]


@pytest.mark.parametrize("shape,cards", list(PLANS),
                         ids=[f"{s[0]}x{s[1]}_on_{c}" for s, c in PLANS])
def test_each_shard_in_its_cards_launch(shape, cards):
    """Every shard is a destination exactly once, in the launch of the
    card it sits on, time-major within the launch; the launches follow
    the cards' first appearance."""
    n_time, n_sc = shape
    m = cycling_mesh(shape, cards)
    plan = halo_dma.plan_launches(m.devices)
    first_seen = list(dict.fromkeys(m.devices.flat))
    assert [dev for dev, _ in plan] == first_seen
    for dev, shards in plan:
        assert shards == [(t, s) for t in range(n_time) for s in range(n_sc)
                          if m.devices[t, s] == dev]
    assert sorted(x for _, shards in plan for x in shards) == [
        (t, s) for t in range(n_time) for s in range(n_sc)]


def test_plan_takes_nested_lists_and_names():
    """The wrapper plans on the halos' own devices, as nested lists; a
    device named twice (an index or a string) is one card."""
    grid = [[cuda(0), "cuda:0"], [torch.device("cuda:1"), cuda(1)]]
    assert halo_dma.plan_launches(grid) == [
        (cuda(0), [(0, 0), (0, 1)]), (cuda(1), [(1, 0), (1, 1)])]
    assert halo_dma.peer_pairs(grid) == [(cuda(1), cuda(0))]
    one = [[cuda(0)]] * 4
    assert halo_dma.plan_launches(one) == [
        (cuda(0), [(0, 0), (1, 0), (2, 0), (3, 0)])]
    assert halo_dma.peer_pairs(one) == []


# (mesh shape, cards) -> (K8 launches, K6 launches) of the full-rate
# stage A, which runs on the mesh's "sc" column 0
STAGE_A = {
    ((4, 1), 4): (4, 4),
    ((2, 2), 4): (2, 2),   # column 0 spans cards 0 and 2
    ((2, 1), 2): (2, 2),
    ((4, 1), 1): (1, 1),
}


@pytest.mark.parametrize("shape,cards", list(STAGE_A),
                         ids=[f"{s[0]}x{s[1]}_on_{c}" for s, c in STAGE_A])
def test_pallas_dma_builds_on_several_cards(shape, cards):
    """build_sharded_decoder(halo_impl="pallas_dma") on a mesh over
    several cards no longer raises at build time; its stage A's K8 plan
    (on column 0) and the per-card K6 stacking give the launch counts
    the card tests assert."""
    n8, n6 = STAGE_A[shape, cards]
    m = cycling_mesh(shape, cards)
    cfg = ModemConfig(pid_max=12, bit_exact=False)
    T = shape[0] * 128 * 512
    dec = ds.build_sharded_decoder(cfg, m, T, halo_impl="pallas_dma",
                                   input_format="planes")
    assert callable(dec)
    column = ds._column(m).devices
    assert len(halo_dma.plan_launches(column)) == n8
    assert len(set(column.flat)) == n6

