"""K6's span plan on the CPU: ``sc_metric.span_scan_emulation`` replays
the kernel's plan (row-major chunks split into one contiguous span per
block, the M-sample history carried in a ring of the window's length
from chunk to chunk, the whole window loaded at a span's first chunk and
where a span enters the next row, prefix sums restarted at each chunk's
window, zero counts only in a window with a zero) and must give the plain
``sc_metric_reference``'s metric: NaN exactly on the windows of zeros,
rtol 2e-3 and atol 1e-4 elsewhere (on samples whose plain energy is not a
cancellation residue), with every (row, t) written exactly once and each
sample loaded once plus one M-sample history per span and row start.  No
kernel and no jax is needed; the kernel itself is held against its plain
version on the card in test_torch_cuda.py."""

import numpy as np
import pytest
import torch

from rub_mimo_tpu_torch.kernels import sc_metric as k6
from rub_mimo_tpu_torch.utils import movsum


def span_start(S: int, T: int, M: int, grid: int, b: int) -> tuple:
    """(row, first position) of block b's first chunk."""
    row_chunks = -(-T // k6.chunk_len(M))
    n_chunks = S * row_chunks
    q = b * n_chunks // min(n_chunks, grid)
    return q // row_chunks, q % row_chunks * k6.chunk_len(M)


# name -> (S, T, M, grid, zero stretches [(row, start, end)])
CASES = {
    # 2 rows of 3 chunks over 3 blocks: block 1 takes row 0's last chunk
    # and row 1's first
    "span_crosses_row_end": (2, 10_000, 64, 3, []),
    "shorter_than_one_chunk": (2, 1_000, 2048, 3, [(1, 0, 300)]),
    "t_is_1": (2, 1, 32, 3, [(1, 0, 1)]),
    "t_not_a_multiple_of_32": (2, 9_001, 64, 1, []),
    "m32": (2, 20_000, 32, 3, [(0, 5_000, 5_100)]),
    "m64": (2, 20_000, 64, 3, [(1, 7_000, 7_200)]),
    "m2048": (2, 30_000, 2048, 3, [(0, 9_000, 15_000)]),
    "m4096": (2, 30_000, 4096, 3, [(1, 1_000, 10_000)]),
    "s1": (1, 25_000, 2048, 3, []),
    "s8": (8, 6_000, 2048, 3, [(5, 2_000, 4_500)]),
    # a one-card sharded stage A: 4 shards x 2 streams, each row an
    # (M - 1)-sample halo and an odd number of samples; shard 0's halo is
    # zeros
    "stacked_odd_rows": (8, 2_047 + 9_000, 2048, 264,
                         [(0, 0, 2_047), (1, 0, 2_047)]),
    "zeros_across_chunk_boundary": (2, 20_000, 64, 1,
                                    [(0, 4_032 - 200, 4_032 + 300)]),
    "zeros_across_span_boundary": (2, 20_000, 64, 3, ["span"]),
    "zeros_whole_row": (3, 12_000, 64, 3, [(1, 0, 12_000)]),
    "grid_1": (8, 140_000, 32, 1, []),
    "grid_3": (8, 140_000, 32, 3, [(3, 60_000, 60_500)]),
    "grid_264": (8, 140_000, 32, 264, [(7, 139_000, 140_000)]),
}


@pytest.mark.parametrize("case", list(CASES))
def test_span_plan_matches_plain_metric(case):
    S, T, M, grid, zero = CASES[case]
    rng = np.random.default_rng(T + M + S)
    x = torch.as_tensor((rng.standard_normal((S, T))
                         + 1j * rng.standard_normal((S, T)))
                        .astype(np.complex64))
    for z in zero:
        if z == "span":  # either side of the start of block 1's span
            s, c0 = span_start(S, T, M, grid, 1)
            assert c0 > 0
            x[s, c0 - 100:c0 + 200] = 0
        else:
            s, a, b = z
            x[s, a:b] = 0
    got, writes, loaded = k6.span_scan_emulation(x, M, grid)
    ref = k6.sc_metric_reference(x, M)
    _, energy = k6.moving_corr_energy(x, M)
    assert got.dtype == torch.float32 and got.shape == (S, T)
    # every output written exactly once
    assert bool((writes == 1).all())
    # each sample loaded once, plus one M-sample history per span (its
    # first chunk) and per row a span enters
    C = k6.chunk_len(M)
    n_chunks = S * -(-T // C)
    G = min(n_chunks, grid)
    assert n_chunks * C <= loaded <= n_chunks * C + (G + S) * M
    # 0/0 exactly on the windows of zeros (counted in integers)
    zeros = movsum.moving_sum((x != 0).to(torch.int64), M) == 0
    assert bool(zeros.any()) == bool(zero)
    np.testing.assert_array_equal(torch.isnan(got).numpy(), zeros.numpy())
    ok = torch.isfinite(ref) & (energy >= 1e-6 * energy.median())
    np.testing.assert_allclose(got[ok].numpy(), ref[ok].numpy(),
                               rtol=2e-3, atol=1e-4)


@pytest.mark.parametrize("M", [32, 64, 2048, 3072, 4096])
def test_chunk_fits_the_plain_block(M):
    """The window (C + M samples, a power of two: the ring) lies within
    the plain version's block of 2^15 + M, and C is a positive multiple
    of 32."""
    W, C = k6.window_len(M), k6.chunk_len(M)
    assert W == C + M and W & (W - 1) == 0
    assert 0 < C and C % 32 == 0 and W <= (1 << 15) + M
