"""K5's two-launch plan on the CPU: ``sc_sync.chunk_scan_emulation``
replays the kernel's chunked scan (per-chunk first and last below, the
body fire, the early-exit bound over waves of resident blocks) and its
resolve (the exclusive-max carry, the head rule), and must give the
plain ``plateau_scan``'s synced, t* and run starts on every pattern,
while scanning every chunk that starts at or before t*.  Metrics are
built from above/below patterns (NaN counts as below), so no kernel and
no jax is needed; the kernel itself is held against its plain version
on the card in test_torch_cuda.py."""

import numpy as np
import pytest
import torch

from rub_mimo_tpu_torch.kernels import sc_sync as k5

THR = 0.95


def runs(S: int, T: int, spans) -> torch.Tensor:
    """Metric [S, T]: 1.0 (above) on each stream's [a, b) spans, 0.0
    (below) elsewhere."""
    m = torch.zeros((S, T), dtype=torch.float32)
    for s, a, b in spans:
        m[s, a:b] = 1.0
    return m


def random_metric(seed: int):
    """Seeded runs of above and below (Markov chain per stream, NaN for
    some below samples), a random T, chunk and cp."""
    rng = np.random.default_rng(seed)
    S = int(rng.integers(1, 9))
    T = int(rng.integers(1, 700))
    C = int(rng.choice([32, 64, 96]))
    cp = int(rng.choice([0, 1, 5, 20, 40, 70]))
    leave_up = rng.uniform(0.002, 0.03)   # long runs above
    leave_down = rng.uniform(0.05, 0.3)   # short runs below
    up = np.zeros((S, T), dtype=bool)
    state = rng.random(S) < 0.5
    for t in range(T):
        flip = rng.random(S) < np.where(state, leave_up, leave_down)
        state = np.where(flip, ~state, state)
        up[:, t] = state
    m = np.where(up, 1.0, 0.0).astype(np.float32)
    m[(~up) & (rng.random((S, T)) < 0.1)] = np.nan
    return torch.as_tensor(m), cp, C


# name -> (metric [S, T], cp, chunk); chunks of 64 unless named
CASES = {
    # stream 0's run crosses the boundary at 128; stream 1's starts in
    # chunk 2's head [128, 133], the fire (136) in its body
    "run_across_boundary_start_in_head": (
        runs(2, 640, [(0, 100, 640), (1, 130, 640)]), 5, 64),
    # the fire at chunk 2's first sample and at its head's last
    "fire_at_head_start": (runs(2, 640, [(0, 100, 640), (1, 122, 640)]),
                           5, 64),
    "fire_at_head_end": (runs(2, 640, [(0, 90, 640), (1, 127, 640)]), 5, 64),
    # stream 0 above for whole chunks (the _dc_run_capture shape): its
    # carry reaches back over six chunks, the fire in a body and a head
    "above_for_whole_chunks_body": (
        runs(2, 900, [(0, 10, 900), (1, 400, 900)]), 5, 64),
    "above_for_whole_chunks_head": (
        runs(2, 900, [(0, 10, 900), (1, 380, 900)]), 5, 64),
    "fire_in_last_chunk": (runs(2, 600, [(0, 570, 600), (1, 580, 600)]),
                           5, 64),
    "fire_on_last_sample": (runs(2, 600, [(0, 500, 600), (1, 593, 600)]),
                            5, 64),
    "shorter_than_one_chunk": (runs(2, 40, [(0, 20, 40), (1, 3, 40)]), 5, 64),
    "shorter_than_one_chunk_no_fire": (runs(2, 40, [(0, 0, 40), (1, 35, 40)]),
                                       5, 64),
    # runs of cp + 1 above samples never fire
    "no_fire": (runs(2, 700, [(s, a, a + 6) for s in (0, 1)
                              for a in range(0, 700, 9)]), 5, 64),
    "no_fire_one_stream_always_above": (runs(2, 700, [(0, 0, 700)]), 5, 64),
    "cp0": (runs(2, 300, [(0, 64, 66), (1, 65, 67), (0, 200, 300),
                          (1, 201, 300)]), 0, 64),
    "cp0_fire_at_chunk_start": (runs(2, 300, [(0, 63, 300), (1, 63, 300)]),
                                0, 64),
    # cp past the chunk: the head is the whole chunk, the body empty
    "cp_beyond_chunk": (runs(2, 700, [(0, 50, 700), (1, 100, 700)]), 90, 64),
    "s1": (runs(1, 500, [(0, 30, 37), (0, 250, 500)]), 5, 64),
    "s3": (runs(3, 500, [(0, 100, 500), (1, 190, 500), (2, 191, 260),
                         (2, 262, 500)]), 5, 64),
    "s8": (runs(8, 800, [(s, 60 * s, 800) for s in range(8)]), 5, 64),
    "s8_no_fire": (runs(8, 800, [(s, 60 * s, 800) for s in range(7)]),
                   5, 64),
    "chunk32": (runs(2, 300, [(0, 40, 300), (1, 61, 300)]), 5, 32),
    **{f"random_{seed}": random_metric(seed) for seed in range(24)},
}


@pytest.mark.parametrize("grid", [1, 4], ids=["grid1", "grid4"])
@pytest.mark.parametrize("case", list(CASES))
def test_emulation_matches_plateau_scan(case, grid):
    metric, cp, C = CASES[case]
    T = metric.shape[1]
    synced, t_star, starts, _ = k5.plateau_scan(metric, cp, THR)
    got = k5.chunk_scan_emulation(metric, cp, THR, C, grid)
    assert bool(got[0]) == bool(synced)
    assert int(got[1]) == int(t_star)
    assert torch.equal(got[2], starts)
    n_chunks = -(-T // C)
    needed = int(t_star) // C + 1 if bool(synced) else n_chunks
    assert needed <= got[3] <= n_chunks


@pytest.mark.parametrize("grid", [1, 8])
def test_early_exit_scans_a_wave_past_the_fire(grid):
    """A fire in chunk 2 of 100: the scan stops within the wave that
    lowered the bound and the next one."""
    C, T = 64, 6400
    metric = runs(2, T, [(0, 130, T), (1, 140, T)])
    got = k5.chunk_scan_emulation(metric, 5, THR, C, grid)
    assert bool(got[0]) and int(got[1]) == 146
    assert 3 <= got[3] <= -(-3 // grid) * grid + grid
    assert got[3] < -(-T // C)


def test_head_fire_found_without_a_body_fire_before_it():
    """Chunk 3's head fires (t* = 194) while the earliest body fire, and
    so the bound, lies later in chunk 3: t* comes from the resolve."""
    metric = runs(2, 640, [(0, 150, 640), (1, 188, 640)])
    got = k5.chunk_scan_emulation(metric, 5, THR, 64, 1)
    assert bool(got[0]) and int(got[1]) == 194
    assert 194 // 64 == 3 and 194 <= 3 * 64 + 5


@pytest.mark.parametrize("dtype", [torch.int32, torch.int64])
@pytest.mark.parametrize("L", [1, 1023, 1024, 1025, 5000])
def test_two_level_cummax_matches_torch_cummax(L, dtype):
    """plateau_scan's running maximum (chunks of 1024) against one
    torch.cummax, on rows shorter than, equal to and across chunks."""
    rng = np.random.default_rng(L)
    x = torch.as_tensor(rng.integers(-5000, 5000, size=(3, L)),
                        dtype=dtype)
    x[1] = -1  # a row with no index, as where every sample is above
    got = k5.cummax(x)
    assert got.dtype == dtype
    assert torch.equal(got, torch.cummax(x, dim=-1).values)
