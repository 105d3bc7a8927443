"""K3/K4's decision-region search and launch plans on the CPU.

``eq_demap.region_table`` builds, per constellation, a 64 x 64 grid of
cells over [-R, R]^2 (R = 2.5 max|c|) with each cell's candidate
points, and ``eq_demap.region_demap_emulation`` replays the kernels'
search (box test, cell, candidates in ascending order, one candidate
deciding alone, the full scan outside the box, on NaN and Inf and in a
cell of more than four candidates).  Here the emulation must decide as
``constellation.hard_demap`` on every modulation, on symbols inside and
outside the box, on cell edges, at exact midpoints of two points, within
1e-6 of such a tie, at zero, NaN and Inf; every cell's list must be
ascending, hold at most four points and every point that wins anywhere
in the cell; the tolerance of the table's test must exceed the rounding
of two float32 scores.  K3's block plan must write each (frame,
subcarrier) once and K4's steps each symbol once.  No kernel and no jax
is needed; the kernels themselves are held against their plain versions
and against their own full scan on the card in test_torch_cuda.py."""

import numpy as np
import pytest
import torch

from rub_mimo_tpu_torch import Modulation
from rub_mimo_tpu_torch.kernels import eq_demap as k34
from rub_mimo_tpu_torch.ofdm import constellation

MODS = [Modulation.BPSK, Modulation.QPSK, Modulation.QAM16,
        Modulation.QAM64, Modulation.QAM256, Modulation.ARB32OPT]


def cell_edges(table):
    """The cells' edges on one axis, as the kernels' float32 cell index
    places them: -box + k / scale, k = 0..GRID."""
    box, scale = (float(v) for v in k34.region_geometry(table))
    return -box + np.arange(k34.GRID + 1) / scale


def symbols(kind: str, table, n: int, seed: int) -> np.ndarray:
    """n complex64 symbols of one kind over ``table``."""
    rng = np.random.default_rng(seed)
    t = np.asarray(table, np.complex64)
    box = float(k34.region_geometry(t)[0])
    if kind == "inside":
        y = rng.uniform(-box, box, n) + 1j * rng.uniform(-box, box, n)
    elif kind == "outside":
        y = rng.uniform(box, 4 * box, n) * np.exp(2j * np.pi * rng.random(n))
        y[:8] = [box, -box, 1j * box, -1j * box, box + 1j * box, 1e30,
                 -1e30j, 1e-3 + 1j * box]
    elif kind == "edges":
        e = cell_edges(t).astype(np.float32)
        on = e[rng.integers(0, len(e), n)]
        on = np.nextafter(on, np.float32(np.inf) * rng.choice([-1, 1], n))
        on = np.where(rng.random(n) < 0.5, on,
                      e[rng.integers(0, len(e), n)]).astype(np.float32)
        other = rng.uniform(-box, box, n)
        y = np.where(rng.random(n) < 0.5, on + 1j * other, other + 1j * on)
        y[:4] = [e[0] + 1j * e[0], e[-1] + 1j * e[-1], e[16] + 1j * e[16],
                 e[0] + 1j * e[-1]]
    elif kind in ("midpoints", "near_ties"):
        p = rng.integers(0, len(t), (2, n))
        y = (t[p[0]].astype(np.complex128) + t[p[1]]) / 2
        if kind == "near_ties":
            y = y + (rng.uniform(-1e-6, 1e-6, n)
                     + 1j * rng.uniform(-1e-6, 1e-6, n))
    elif kind == "zero":
        y = np.zeros(n)
        y[1::2] = -0.0
    elif kind == "nan":
        y = np.zeros(n, np.complex64)
        y.real = np.where(np.arange(n) % 3 == 1, 0.2, np.nan)
        y.imag = np.where(np.arange(n) % 3 == 2, 0.2, np.nan)
    elif kind == "inf":
        y = np.zeros(n, np.complex64)
        inf = np.inf * rng.choice([-1, 1], n)
        part = rng.uniform(-box, box, n)
        re_inf = np.arange(n) % 2 == 0
        y.real = np.where(re_inf, inf, part)
        y.imag = np.where(re_inf, part, inf)
    else:
        raise ValueError(kind)
    return np.asarray(y, np.complex64)


KINDS = ["inside", "outside", "edges", "midpoints", "near_ties", "zero",
         "nan", "inf"]


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("mod", MODS, ids=lambda m: m.name)
def test_search_decides_as_hard_demap(mod, kind):
    table = constellation.table(mod)
    y = torch.as_tensor(symbols(kind, table, 20_000, len(table) + len(kind)))
    got = k34.region_demap_emulation(y, table)
    assert got.dtype == torch.int32 and got.shape == y.shape
    assert torch.equal(got, constellation.hard_demap(y, table))


@pytest.mark.parametrize("mod", MODS, ids=lambda m: m.name)
def test_search_decides_probe_symbols_as_hard_demap(mod):
    """The symbols test_torch_cuda.py and chip_smoke.py hand the kernels."""
    table = constellation.table(mod)
    y = torch.as_tensor(k34.probe_symbols(table, 30_000, 3))
    assert torch.equal(k34.region_demap_emulation(y, table),
                       constellation.hard_demap(y, table))


@pytest.mark.parametrize("mod", MODS, ids=lambda m: m.name)
def test_cell_lists(mod):
    """Each cell word: 1..4 candidates, ascending, the last repeated into
    the unused slots; no cell of the six tables needs the full scan."""
    table = constellation.table(mod)
    words = k34.region_table(table)
    assert words.dtype == np.uint32 and words.shape == (k34.GRID ** 2,)
    assert not (words == k34.FULL_SCAN).any()
    for w in words.tolist():
        slots = [(w >> (8 * i)) & 0xFF for i in range(k34.SLOTS)]
        cand = k34.cell_candidates(w)
        assert 1 <= len(cand) <= k34.SLOTS
        assert cand == sorted(set(cand)) and max(cand) < len(table)
        assert slots == cand + [cand[-1]] * (k34.SLOTS - len(cand))


@pytest.mark.parametrize("mod", MODS, ids=lambda m: m.name)
def test_cells_hold_every_winner(mod):
    """A dense sample of each cell (9 x 9 points from edge to edge): the
    plain demap's winner at each is among the cell's candidates."""
    table = constellation.table(mod)
    words = k34.region_table(table)
    e = cell_edges(table)
    u = np.linspace(0, 1, 9)
    for iy in range(k34.GRID):
        yi = e[iy] + u * (e[iy + 1] - e[iy])
        for ix in range(k34.GRID):
            yr = e[ix] + u * (e[ix + 1] - e[ix])
            y = torch.as_tensor((yr[:, None] + 1j * yi[None, :]).astype(
                np.complex64))
            won = set(constellation.hard_demap(y, table).flatten().tolist())
            assert won <= set(k34.cell_candidates(
                int(words[iy * k34.GRID + ix]))), (iy, ix)


@pytest.mark.parametrize("mod", MODS, ids=lambda m: m.name)
def test_tolerance_exceeds_score_rounding(mod):
    """The table's tolerance exceeds the rounding of two float32 scores
    at |y| <= sqrt(2) R, in the kernels' two FMAs and in hard_demap's
    three rounded operations, measured against float64 scores."""
    table = constellation.table(mod)
    cr, ci, cb = constellation.demap_planes(table)
    box = float(k34.region_geometry(table)[0])
    rng = np.random.default_rng(11)
    yr = rng.uniform(-box, box, 4000).astype(np.float32)[:, None]
    yi = rng.uniform(-box, box, 4000).astype(np.float32)[:, None]
    exact = (yr.astype(np.float64) * cr + yi.astype(np.float64) * ci
             - cb.astype(np.float64))
    # an FMA rounds once: its float64 value (exact products of float32
    # values) rounded to float32
    inner = (yi.astype(np.float64) * ci - cb).astype(np.float32)
    fma = (yr.astype(np.float64) * cr + inner).astype(np.float32)
    plain = (yr * cr + yi * ci) - cb
    err = max(np.abs(fma - exact).max(), np.abs(plain - exact).max())
    assert 2 * err < k34.score_tolerance(table) / 8


def test_crowded_cells_take_the_full_scan():
    """Sixteen points on a small ring about the origin and one far out:
    the central cells hold more than four candidates, go to the full
    scan, and the search still decides as hard_demap."""
    ring = 0.05 * np.exp(2j * np.pi * np.arange(16) / 16)
    table = np.concatenate([ring, [1.0]]).astype(np.complex64)
    words = k34.region_table(table)
    assert (words == k34.FULL_SCAN).sum() >= 4
    y = torch.as_tensor(np.concatenate([
        symbols("inside", table, 5000, 1), 0.06 * symbols("inside", table,
                                                          5000, 2),
        symbols("midpoints", table, 2000, 3)]))
    assert torch.equal(k34.region_demap_emulation(y, table),
                       constellation.hard_demap(y, table))


@pytest.mark.parametrize("S", [1, 2, 3, 4])
@pytest.mark.parametrize("M,n_sym,blocks_per_sm,sms", [
    (1, 1, 16, 132), (129, 1, 8, 132), (2048, 1000, 5, 132),
    (2047, 7, 3, 2), (64, 100_000 // 64, 10, 132), (4097, 3, 1, 1),
    (300, 2, 1, 1), (600_000, 2, 1, 2)])
def test_eq_block_plan_writes_each_output_once(S, M, n_sym, blocks_per_sm,
                                               sms):
    """K3's blocks (tile b % tiles, frames b // tiles + i ranges) cover
    each (frame, subcarrier) once, in one wave of blocks unless the tiles
    alone need more, with the frames split evenly to within one."""
    bps = blocks_per_sm + S - 1  # more streams, more registers: any count
    plan = k34.eq_block_plan(M, n_sym, bps, sms)
    writes = k34.plan_writes("eq_demap", M=M, n_sym=n_sym,
                             blocks_per_sm=bps, sms=sms)
    assert writes.shape == (n_sym, M)
    assert bool((writes == 1).all())
    assert 1 <= plan["ranges"] <= n_sym
    assert plan["grid"] <= max(plan["tiles"], bps * sms)
    assert (plan["ranges"] == n_sym
            or (plan["ranges"] + 1) * plan["tiles"] > bps * sms)


@pytest.mark.parametrize("n,head,sms", [
    (1, 0, 1), (1, 1, 1), (2, 1, 1), (3, 0, 1), (4, 0, 1), (5, 1, 1),
    (8, 1, 1), (4099, 0, 1), (4097, 1, 1), (4100, 1, 1), (4101, 1, 1),
    (70_001, 1, 2), (70_001, 1, 132)])
def test_demap_steps_write_each_symbol_once(n, head, sms):
    """K4's steps (four symbols a thread, its unaligned head symbol and
    its last numel % 4 symbols apart, where that fills FILL_BLOCKS
    blocks per SM; else one) in a grid-stride loop over at most one wave:
    each symbol once."""
    plan = k34.demap_plan(n, head, 2, sms)
    fill = (n - head) // 4 >= k34.FILL_BLOCKS * sms * k34.DEMAP_THREADS
    assert plan["per_thread"] == (4 if fill else 1)
    assert plan["head"] == (head if fill else 0)
    writes = k34.plan_writes("demap", n=n, head=head, blocks_per_sm=2,
                             sms=sms)
    assert bool((writes == 1).all())
