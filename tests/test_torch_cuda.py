"""The port on an NVIDIA GPU: the CUDA kernels (K1 strip-fused payload
tail, K2 fused payload tail, K3 equalize + demap, K4 hard demap, K5
one-pass sync, K6 S&C metric, K7 CP strip, K8 halo exchange, and the
Viterbi of the coded chain) against their plain PyTorch versions, the
decode on the card against the decode on the CPU, on every payload tail
and mode (and the coded chain, decode_with_sfo and the streamed SFO
correction), and the sharded decode on one-card meshes against the
single-device decode, with the launch counts of each path.  On several cards: K1/K2 on each card, K8 pulling halos
across cards (and the ordering of its read), the sharded decode with one
shard per card and batched serving over the cards.  Every test here is
marked ``cuda`` and skips without a GPU (the multi-card ones with fewer
cards than they need).

This file imports neither jax nor the JAX package, so it also runs where
jax is not installed:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

from rub_mimo_tpu_torch import (CommMode, Detector, ModemConfig, Modulation,
                                tiny_config)
from rub_mimo_tpu_torch.detect import zf
from rub_mimo_tpu_torch.io import simulator
from rub_mimo_tpu_torch.kernels import cp_strip as k7
from rub_mimo_tpu_torch.kernels import eq_demap as k34
from rub_mimo_tpu_torch.kernels import halo_dma as k8
from rub_mimo_tpu_torch.kernels import payload_fused as pf
from rub_mimo_tpu_torch.kernels import sc_metric as k6
from rub_mimo_tpu_torch.kernels import sc_sync as k5
from rub_mimo_tpu_torch.ofdm import constellation
from rub_mimo_tpu_torch.parallel import decode_sharded as ds
from rub_mimo_tpu_torch.parallel import mesh as pmesh
from rub_mimo_tpu_torch.pipeline import report, rx, streaming
from rub_mimo_tpu_torch.utils import movsum

pytestmark = pytest.mark.cuda

torch.set_num_threads(1)

# the sizes of tests/torch_oracle.py's TINY and MID, as the port's configs
TINY = tiny_config()                              # M=64, bit_exact (per-code)
MID = ModemConfig(pid_max=12, bit_exact=False)    # M=2048, joint timing
TIE_MARGIN = 1e-4  # decisions may differ only where the plain scores tie


def require_cuda() -> torch.device:
    """Skip the calling test unless a CUDA device is present (decided
    inside the test, never at import)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is "
                    "false)")
    return torch.device("cuda")


def n(x: torch.Tensor) -> np.ndarray:
    return x.detach().cpu().numpy()


def random_tail_inputs(seed: int, S: int, M: int, cp: int, n_sym: int):
    """Seeded flat payload planes [S, n_sym*(M+cp)] f32 (x2) and a
    well-conditioned channel G [M, S, S] complex64 (numpy)."""
    rng = np.random.default_rng(seed)
    p = rng.standard_normal((2, S, n_sym * (M + cp))).astype(np.float32)
    G = ((rng.standard_normal((M, S, S))
          + 1j * rng.standard_normal((M, S, S))) / np.sqrt(2)
         + 2.0 * np.eye(S)).astype(np.complex64)
    return p[0], p[1], G


def top2_margin(y: torch.Tensor, table: np.ndarray) -> torch.Tensor:
    """The plain demap's best minus second-best score at each y."""
    c = torch.as_tensor(constellation.demap_planes(table), device=y.device)
    scores = (y.real.unsqueeze(-1) * c[0] + y.imag.unsqueeze(-1) * c[1]
              - c[2])
    top = torch.topk(scores, 2, dim=-1).values
    return top[..., 0] - top[..., 1]


def assert_decisions_match(got, ref, y_ref, table) -> None:
    """Decisions equal but where the plain scores at y_ref tie to within
    TIE_MARGIN (FMA contraction in the kernels)."""
    bad = got != ref
    if bool(bad.any()):
        assert bool((top2_margin(y_ref[bad], table) < TIE_MARGIN).all())


def _tail_case(dev, M, cp, n_sym, S=2, offset=0, mod=Modulation.ARB32OPT):
    """K1's inputs; ``offset`` floats ahead of each plane in its buffer
    (an offset that is not a multiple of 4 takes the 4-byte copies)."""
    p_re, p_im, G = random_tail_inputs(M + n_sym, S, M, cp, n_sym)
    W, gain = zf.invert(torch.as_tensor(G, device=dev))

    def plane(p):
        buf = torch.zeros(offset + p.size, dtype=torch.float32, device=dev)
        buf[offset:] = torch.as_tensor(p.ravel(), device=dev)
        return buf[offset:].view(p.shape)

    args = (plane(p_re), plane(p_im), W, gain, constellation.table(mod),
            np.float32(1.0 / np.sqrt(M)))
    return args, dict(n_sym=n_sym, symbol_len=M + cp, cp_len=cp)


# (S, M, cp, n_sym, plane offset in floats, modulation): every M of the
# gate, odd CPs and unaligned planes (4-byte copies), one- and two-stage
# blocks, 2, 4, 16, 32 and 64 points
A32, QAM16, QAM64 = Modulation.ARB32OPT, Modulation.QAM16, Modulation.QAM64
TAIL_CASES = {
    "m64": (2, 64, 16, 8, 0, A32),
    "m128_bpsk": (2, 128, 8, 6, 0, Modulation.BPSK),
    "m256_qpsk": (2, 256, 20, 5, 0, Modulation.QPSK),
    "m512_qam16": (2, 512, 36, 5, 0, QAM16),
    "m1024": (2, 1024, 72, 5, 0, A32),
    "m2048": (2, 2048, 152, 13, 0, A32),
    "m4096_qam64": (2, 4096, 288, 3, 0, QAM64),
    "m2048_odd_cp": (2, 2048, 151, 7, 0, A32),
    "m2048_offset1": (2, 2048, 152, 7, 1, A32),
    "m256_odd_cp_offset3": (2, 256, 17, 9, 3, QAM16),
    "s1_m4096": (1, 4096, 288, 4, 0, A32),
    "s3_m1024_qam64": (3, 1024, 72, 4, 0, QAM64),
    "s4_m2048": (4, 2048, 152, 5, 0, QAM16),
    "s4_m4096_offset2": (4, 4096, 290, 3, 2, Modulation.QPSK),
}


@pytest.mark.parametrize("case", list(TAIL_CASES))
def test_kernel_matches_plain_tail(case):
    dev = require_cuda()
    S, M, cp, n_sym, offset, mod = TAIL_CASES[case]
    args, kw = _tail_case(dev, M, cp, n_sym, S, offset, mod)
    before = pf.payload_fused_strip.launches
    sig, data = pf.payload_fused_strip(*args, **kw)
    ref_sig, ref_data = pf.payload_tail_reference(*args, **kw)
    torch.cuda.synchronize()
    assert pf.payload_fused_strip.launches == before + 1
    assert data.dtype == torch.int32 and data.shape == ref_data.shape
    assert int((data != ref_data).sum()) == 0
    rms = float(torch.sqrt(torch.mean(ref_sig.abs() ** 2)))
    assert float((sig - ref_sig).abs().max()) <= 1e-4 * rms
    _, data_only = pf.payload_fused_strip(*args, emit_sig=False, **kw)
    assert torch.equal(data_only, data)


@pytest.mark.parametrize("where", ["below", "equal", "above"])
@pytest.mark.parametrize("S", [2, 4], ids=["two_stage", "one_stage"])
@pytest.mark.parametrize("kernel", ["payload_fused_strip", "payload_fused"])
def test_fused_tails_around_the_grid_size(kernel, S, where):
    """n_sym one below, equal to and one above the persistent grid's
    blocks per SM x SMs, at M = 2048."""
    dev = require_cuda()
    M, cp = 2048, 152
    full = pf.launch_geometry(kernel, S, M, 1 << 20)
    cap = full["blocks_per_sm"] * full["sms"]
    assert full["grid"] == cap and full["two_stage"] == (S * M <= 4096)
    n_sym = cap + {"below": -1, "equal": 0, "above": 1}[where]
    assert pf.launch_geometry(kernel, S, M, n_sym)["grid"] == min(n_sym, cap)
    args, kw = _tail_case(dev, M, cp, n_sym, S)
    table = args[4]
    if kernel == "payload_fused":
        x = k7.cp_strip(torch.complex(args[0], args[1]), n_sym, M + cp, cp)
        args = (x, *args[2:])
        sig, data = pf.payload_fused(*args)
        ref_sig, ref_data = pf.payload_fused_reference(*args)
    else:
        sig, data = pf.payload_fused_strip(*args, **kw)
        ref_sig, ref_data = pf.payload_tail_reference(*args, **kw)
    torch.cuda.synchronize()
    assert data.shape == (S, n_sym, M)
    assert_decisions_match(data, ref_data, ref_sig, table)
    rms = float(torch.sqrt(torch.mean(ref_sig.abs() ** 2)))
    assert float((sig - ref_sig).abs().max()) <= 1e-4 * rms


def require_cuda_devices(count: int) -> list[torch.device]:
    """Skip the calling test unless `count` or more CUDA devices are
    present; the devices in index order."""
    require_cuda()
    if torch.cuda.device_count() < count:
        pytest.skip(f"needs {count} or more NVIDIA GPUs "
                    f"({torch.cuda.device_count()} present)")
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


@pytest.mark.parametrize("S", [2, 4], ids=["two_stage", "one_stage"])
def test_fused_tails_on_every_device(S):
    """K1 and K2 on each card in turn: each device's context needs the
    raised shared-memory limit (the two-stage block takes 86 KB)."""
    M, cp, n_sym = 2048, 152, 9
    for dev in require_cuda_devices(2):
        args, kw = _tail_case(dev, M, cp, n_sym, S)
        x = k7.cp_strip(torch.complex(args[0], args[1]), n_sym, M + cp, cp)
        for got, (ref_sig, ref_data) in (
                (pf.payload_fused_strip(*args, **kw),
                 pf.payload_tail_reference(*args, **kw)),
                (pf.payload_fused(x, *args[2:]),
                 pf.payload_fused_reference(x, *args[2:]))):
            sig, data = got
            torch.cuda.synchronize(dev)
            assert data.device == dev and data.shape == (S, n_sym, M)
            assert_decisions_match(data, ref_data, ref_sig, args[4])
            rms = float(torch.sqrt(torch.mean(ref_sig.abs() ** 2)))
            assert float((sig - ref_sig).abs().max()) <= 1e-4 * rms


def test_kernel_rejects_what_it_cannot_take():
    dev = require_cuda()
    args, kw = _tail_case(dev, 64, 16, 4)
    p_re, p_im, W, gain, tab, norm = args
    with pytest.raises(ValueError):
        pf.payload_fused_strip(p_re.double(), p_im, W, gain, tab, norm, **kw)
    with pytest.raises(ValueError):
        pf.payload_fused_strip(p_re.cpu(), p_im, W, gain, tab, norm, **kw)
    with pytest.raises(ValueError):
        pf.payload_fused_strip(p_re, p_im, W, gain,
                               constellation.table(Modulation.QAM256), norm,
                               **kw)


def _capture(cfg, **spec_kw):
    spec = simulator.ChannelSpec(**{**dict(snr_db=30.0, seed=11), **spec_kw})
    return simulator.simulate_capture(cfg, spec, device="cpu")[0]


def _dc_run_capture(T=60_000, late=50_000):
    """Stream 0 is a constant (metric 1 from t = M on); stream 1 is noise
    until ``late``, then constant: the fire comes ~late + M + cp, with
    stream 0's run reaching back over many tiles."""
    rng = np.random.default_rng(4)
    x = np.full((2, T), 0.5 + 0.25j, np.complex64)
    x[1, :late] = (rng.standard_normal(late)
                   + 1j * rng.standard_normal(late)).astype(np.complex64)
    return torch.as_tensor(x)


def _run_into_chunk(cfg, lead: int, S: int = 2):
    """Stream 0 constant (above from ~M on, its run crossing every chunk
    boundary); the other streams noise, then constant from ``late`` on,
    with ``late`` placed so that their run starts ``lead`` samples after
    the start c0 = 3 C of a kernel chunk (C from the built kernel, the run
    start from the plain version on the CPU).  The noise is the tail of
    one seeded array, so the samples before ``late`` are the same for
    every ``late``.  lead in [0, cp] starts the run in the chunk's head;
    lead = -cp - 1 puts the fire on c0, lead = -cp on c0 + 1."""
    C = k5.chunk_len(cfg.M)
    c0 = 3 * C
    rng = np.random.default_rng(5)
    noise = (rng.standard_normal(c0 + cfg.M)
             + 1j * rng.standard_normal(c0 + cfg.M)).astype(np.complex64)

    def build(late):
        x = np.full((S, late + 2 * C), 0.5 + 0.25j, np.complex64)
        x[1:, :late] = noise[noise.size - late:]
        return torch.as_tensor(x)

    def run_start(x):
        starts = k5.sc_sync_reference(x, cfg.M, cfg.cp_len,
                                      cfg.plateau_threshold)[2]
        return int(starts[1])

    late0 = c0 - cfg.M
    late = late0 + c0 + lead - run_start(build(late0))
    x = build(late)
    assert run_start(x) == c0 + lead
    return x


def _fire_in_last_chunk(cfg, x):
    """x cut to end 5 samples short of the end of t*'s chunk."""
    C = k5.chunk_len(cfg.M)
    t_star = int(k5.sc_sync_reference(x, cfg.M, cfg.cp_len,
                                      cfg.plateau_threshold)[1])
    return x[:, :(t_star // C + 1) * C - 5].contiguous()


def _three_streams(x, lag: int = 40):
    """x's two streams and stream 0 delayed by ``lag`` samples."""
    late = torch.nn.functional.pad(x[0], (lag, 0))[:x.shape[1]]
    return torch.stack([x[0], x[1], late])


M4096 = ModemConfig(num_subcarriers=4096, cp_len=288, pid_max=3,
                    bit_exact=False)
OP_T = 2_297_248  # the reference operating point's capture length

# TINY is M=64 (8128-sample chunks), MID M=2048 (6144), M4096 (4096)
SYNC_CASES = {
    "d501": lambda: (TINY, _capture(TINY, delay=501)),
    "d130_snr30": lambda: (TINY, _capture(TINY, delay=130)),
    "d2000_snr25": lambda: (TINY, _capture(TINY, delay=2000,
                                                  snr_db=25.0)),
    "d64_first_tile": lambda: (TINY, _capture(TINY, delay=64)),
    "late_fire": lambda: (TINY, _capture(TINY, delay=40_400,
                                                trailing=100)),
    "noise_only": lambda: (TINY, torch.as_tensor(
        (0.01 * np.random.default_rng(0).standard_normal((2, 9000, 2)))
        .astype(np.float32).view(np.complex64)[..., 0])),
    "leading_zeros": lambda: (TINY, torch.nn.functional.pad(
        _capture(TINY, delay=300), (100_000, 0))),
    "run_across_tiles": lambda: (TINY, _dc_run_capture()),
    "mid": lambda: (MID, _capture(MID, delay=7000)),
    # the head rule: a run across a chunk boundary whose other stream
    # starts in the next chunk's head; fires on and just after c0
    "run_start_in_head_m64": lambda: (TINY, _run_into_chunk(TINY, 8)),
    "run_start_in_head_m2048": lambda: (MID, _run_into_chunk(MID, 100)),
    "fire_on_chunk_start_m2048": lambda: (MID, _run_into_chunk(MID, -153)),
    "fire_in_head_m2048": lambda: (MID, _run_into_chunk(MID, -152)),
    "fire_in_head_m4096": lambda: (M4096, _run_into_chunk(M4096, -200)),
    "fire_in_last_chunk_m2048": lambda: (MID, _fire_in_last_chunk(
        MID, _capture(MID, delay=7000))),
    "fire_in_last_chunk_m64": lambda: (TINY, _fire_in_last_chunk(
        TINY, _capture(TINY, delay=5000))),
    "s1": lambda: (MID, _capture(MID, delay=7000)[:1].contiguous()),
    "s3": lambda: (MID, _three_streams(_capture(MID, delay=7000))),
    "m4096": lambda: (M4096, _capture(M4096, delay=9000)),
    "no_fire_operating_length": lambda: (MID, torch.as_tensor(
        (np.random.default_rng(8).standard_normal((2, OP_T, 2)))
        .astype(np.float32).view(np.complex64)[..., 0])),
}
NO_FIRE = ("noise_only", "no_fire_operating_length")


@pytest.mark.parametrize("case", list(SYNC_CASES))
def test_sc_sync_kernel_matches_plain(case):
    dev = require_cuda()
    cfg, x = SYNC_CASES[case]()
    x = x.to(dev)
    args = (x, cfg.M, cfg.cp_len, cfg.plateau_threshold)
    before = k5.sc_sync_fused.launches
    got = k5.sc_sync_fused(*args)
    ref = k5.sc_sync_reference(*args)
    torch.cuda.synchronize()
    assert k5.sc_sync_fused.launches == before + 1
    for a, b, name in zip(got[:3], ref[:3], ("synced", "t_star", "starts")):
        assert a.dtype == b.dtype, name
        np.testing.assert_array_equal(n(a), n(b), err_msg=name)
    cfo = [float(torch.angle((-c).sum()) / np.pi) for c in (got[3], ref[3])]
    assert abs(cfo[0] - cfo[1]) < 1e-4
    assert bool(got[0]) == (case not in NO_FIRE)
    # every chunk that starts at or before t* was scanned
    C = k5.chunk_len(cfg.M)
    chunks = k5.sc_sync_fused.chunks
    needed = int(ref[1]) // C + 1 if bool(ref[0]) else chunks
    assert needed <= int(k5.sc_sync_fused.chunks_scanned) <= chunks


def test_sc_sync_stops_after_an_early_fire():
    """A fire in chunk 1 of a capture padded to ~510 chunks: the scan
    reads the chunks the resident blocks had taken, about two waves of
    the persistent grid at most, and not the rest."""
    dev = require_cuda()
    x = torch.nn.functional.pad(_capture(MID, delay=7000),
                                (0, 3_000_000)).to(dev)
    args = (x, MID.M, MID.cp_len, MID.plateau_threshold)
    got = k5.sc_sync_fused(*args)
    ref = k5.sc_sync_reference(*args)
    torch.cuda.synchronize()
    assert bool(got[0]) and int(got[1]) == int(ref[1])
    assert torch.equal(got[2], ref[2])
    C = k5.chunk_len(MID.M)
    chunks, scanned = k5.sc_sync_fused.chunks, int(
        k5.sc_sync_fused.chunks_scanned)
    geo = k5.scan_geometry(*x.shape, MID.M, dev)
    assert geo["chunk"] == C and chunks == -(-x.shape[1] // C)
    assert geo["grid"] == min(chunks, geo["blocks_per_sm"] * geo["sms"])
    assert int(ref[1]) // C + 1 <= scanned <= int(ref[1]) // C + 1 \
        + 2 * geo["grid"]
    assert scanned < chunks


def _span_boundary(S: int, T: int, M: int, dev) -> tuple:
    """(row, first position) of the chunk that starts the kernel's second
    span on dev's grid for an [S, T] capture."""
    geo = k6.metric_geometry(S, T, M, dev)
    row_chunks = -(-T // geo["chunk"])
    q = S * row_chunks // geo["grid"]
    return q // row_chunks, q % row_chunks * geo["chunk"]


# name -> (S, T, M, zeros): zeros "stretch" is 3 M zero samples from 5000
# on every row, "halo" the first M - 1 samples of rows 0 and 1 (a sharded
# stage A's first shard), "lead" the first 700 samples of every row, "span"
# M + 200 samples either side of the start of the second span.  Every case
# longer than one chunk has more than two chunks per block on an H100's
# grid, so that its blocks read their history from the ring
METRIC_CASES = {
    "m64": (2, 1_200_777, 64, "stretch"),
    "m2048": (2, (1 << 20) + 777, 2048, "stretch"),
    "m4096": (2, 700_001, 4096, "stretch"),
    "s1": (1, 1_200_000, 2048, "stretch"),
    "s8": (8, 300_000, 64, "stretch"),
    "stacked_odd_rows": (8, 200_001, 2048, "halo"),
    "shorter_than_one_chunk": (2, 1_500, 2048, "lead"),
    "m32": (2, 1_200_001, 32, "stretch"),
    "zeros_across_span_boundary": (2, (1 << 20) + 777, 2048, "span"),
}


@pytest.mark.parametrize("case", list(METRIC_CASES))
def test_sc_metric_kernel_matches_plain(case):
    dev = require_cuda()
    S, T, M, zero = METRIC_CASES[case]
    rng = np.random.default_rng(T)
    x = torch.as_tensor((rng.standard_normal((S, T))
                         + 1j * rng.standard_normal((S, T)))
                        .astype(np.complex64), device=dev)
    if zero == "stretch":
        x[:, 5000:5000 + 3 * M] = 0
    elif zero == "halo":
        x[:2, :M - 1] = 0
    elif zero == "lead":
        x[:, :700] = 0
    else:
        s, c0 = _span_boundary(S, T, M, dev)
        assert c0 > 0
        x[s, c0 - M - 200:c0 + M + 200] = 0
    geo = k6.metric_geometry(S, T, M, dev)
    n_chunks = S * -(-T // geo["chunk"])
    assert T < geo["chunk"] or n_chunks > 2 * geo["grid"], (n_chunks, geo)
    before = k6.sc_metric_fused.launches
    got = k6.sc_metric_fused(x, M)
    ref = k6.sc_metric_reference(x, M)
    _, energy = k6.moving_corr_energy(x, M)
    torch.cuda.synchronize()
    assert k6.sc_metric_fused.launches == before + 1
    assert got.dtype == torch.float32 and got.shape == ref.shape
    # 0/0 exactly on the windows of zeros (counted in integers)
    zeros = movsum.moving_sum((x != 0).to(torch.int64), M) == 0
    assert bool(zeros.any())
    np.testing.assert_array_equal(n(torch.isnan(got)), n(zeros))
    # elsewhere the tolerance of the JAX package's kernel test, on samples
    # whose plain energy is not a cancellation residue
    ok = torch.isfinite(ref) & (energy >= 1e-6 * energy.median())
    np.testing.assert_allclose(n(got[ok]), n(ref[ok]),
                               rtol=2e-3, atol=1e-4)


@pytest.mark.parametrize("S,T,M", [(2, 2_297_248, 2048), (8, 576_383, 2048),
                                   (2, 576_383, 2048), (1, 1, 32),
                                   (2, 50_000, 4096), (65535, 100, 64)])
def test_sc_metric_geometry(S, T, M):
    """The persistent grid: the occupancy calculator's blocks per SM x
    SMs at most, one block per chunk at most, chunks of chunk_len(M)
    whose window (C + M samples) lies within the plain version's block
    of 2^15 + M; two blocks per SM up to M = 2048."""
    dev = require_cuda()
    geo = k6.metric_geometry(S, T, M, dev)
    C = geo["chunk"]
    assert C == k6.chunk_len(M) and C + M == k6.window_len(M)
    assert C + M <= (1 << 15) + M and C >= 32
    n_chunks = S * -(-T // C)
    full = geo["blocks_per_sm"] * geo["sms"]
    assert geo["grid"] == min(n_chunks, full) <= full
    assert geo["threads"] * 16 == k6.window_len(M)
    assert geo["blocks_per_sm"] >= (2 if M <= 2048 else 1)


def test_sync_kernels_reject_what_they_cannot_take():
    dev = require_cuda()
    x = torch.zeros((2, 1000), dtype=torch.complex64, device=dev)
    for bad in (x.to(torch.complex128), x[:, ::2], x[0]):
        with pytest.raises(ValueError):
            k6.sc_metric_fused(bad, 64)
        with pytest.raises(ValueError):
            k5.sc_sync_fused(bad, 64, 16, 0.95)
    for M in (48, 8192):
        with pytest.raises(ValueError):
            k6.sc_metric_fused(x, M)
        with pytest.raises(ValueError):
            k5.sc_sync_fused(x, M, 16, 0.95)
    with pytest.raises(ValueError):
        k5.sc_sync_fused(torch.zeros((9, 1000), dtype=torch.complex64,
                                     device=dev), 64, 16, 0.95)


@pytest.mark.parametrize("cfg", [TINY, MID],
                         ids=["tiny", "mid"])
def test_decode_on_card_matches_cpu(cfg):
    dev = require_cuda()
    spec = simulator.ChannelSpec(snr_db=30.0, delay=3000, seed=3)
    cap, tx, _ = simulator.simulate_capture(cfg, spec, device="cpu")
    on_cpu = rx.make_decoder(cfg, device="cpu")(cap)
    before = pf.payload_fused_strip.launches
    on_card = rx.make_decoder(cfg, device=dev, input_format="planes")(
        cap.real.contiguous(), cap.imag.contiguous())
    assert pf.payload_fused_strip.launches == before + 1
    for f in ("synced", "sync_index", "sync_sample", "plateau_start",
              "s0_index", "ac_index", "decode_start", "rx_data",
              "symbol_valid"):
        np.testing.assert_array_equal(n(getattr(on_card, f)),
                                      n(getattr(on_cpu, f)),
                                      err_msg=f)
    np.testing.assert_allclose(n(on_card.G), n(on_cpu.G),
                               rtol=1e-4, atol=1e-6)
    assert report.score(on_card, tx, cfg).symbol_error_rate == [0.0, 0.0]


# (config change, capture options, decoder options, (K5, K6) launches)
CARD_OPTION_CASES = {
    "sync_pallas": (dict(), dict(), dict(sync_impl="pallas"), (1, 0)),
    "keep_debug": (dict(), dict(), dict(keep_debug=True), (0, 1)),
    "cfo_options": (dict(correct_cfo=True, sync_fallback=True,
                         smooth_channel=True, bit_exact=False,
                         detector=Detector.MMSE, mmse_auto_noise=True),
                    dict(cfo_subcarriers=0.05), dict(), (0, 0)),
}


@pytest.mark.parametrize("case", list(CARD_OPTION_CASES))
@pytest.mark.parametrize("cfg", [TINY, MID],
                         ids=["tiny", "mid"])
def test_decode_options_on_card_match_cpu(cfg, case):
    dev = require_cuda()
    change, cap_kw, kw, (n5, n6) = CARD_OPTION_CASES[case]
    cfg = cfg.replace(**change)
    spec = simulator.ChannelSpec(snr_db=30.0, delay=3000, seed=3, **cap_kw)
    cap, tx, _ = simulator.simulate_capture(cfg, spec, device="cpu")
    on_cpu = rx.make_decoder(cfg, device="cpu", **kw)(cap)
    counts = (k5.sc_sync_fused, k6.sc_metric_fused, pf.payload_fused_strip)
    before = [c.launches for c in counts]
    on_card = rx.make_decoder(cfg, device=dev, input_format="planes", **kw)(
        cap.real.contiguous(), cap.imag.contiguous())
    torch.cuda.synchronize()
    assert [c.launches - b for c, b in zip(counts, before)] == [n5, n6, 1]
    for f in ("synced", "sync_index", "sync_sample", "plateau_start",
              "plateau_end", "s0_index", "ac_index", "decode_start",
              "rx_data", "symbol_valid"):
        np.testing.assert_array_equal(n(getattr(on_card, f)),
                                      n(getattr(on_cpu, f)),
                                      err_msg=f)
    np.testing.assert_allclose(n(on_card.G), n(on_cpu.G),
                               rtol=1e-4, atol=1e-6)
    assert abs(float(on_card.cfo_hat) - float(on_cpu.cfo_hat)) < 1e-4
    if case == "keep_debug":
        m, ref = on_card.metric, on_cpu.metric
        assert m.dtype == torch.float32 and m.shape == cap.shape
        near = ref > 0.5  # the metric is read only near its threshold
        np.testing.assert_allclose(n(m.cpu()[near]),
                                   n(ref[near]), rtol=0, atol=1e-5)
    if case == "cfo_options":
        assert abs(float(on_card.cfo_hat) - 0.05) < 1e-3
    assert report.score(on_card, tx, cfg).symbol_error_rate == [0.0, 0.0]


# ---- K7, K4, K3, K2: the payload kernels of the generic tail ----

@pytest.mark.parametrize("dtype", [torch.complex64, torch.float32],
                         ids=["c64", "f32"])
@pytest.mark.parametrize("S,M,cp,n_sym,extra", [
    (2, 2048, 152, 40, 0), (2, 64, 16, 9, 5), (1, 50, 14, 7, 3),
    (3, 33, 7, 5, 1)])
def test_cp_strip_kernel_matches_plain(dtype, S, M, cp, n_sym, extra):
    dev = require_cuda()
    rng = np.random.default_rng(M + n_sym)
    L = n_sym * (M + cp) + extra
    x = torch.as_tensor(rng.standard_normal((S, 2 * L)).astype(np.float32),
                        device=dev)
    x = x.view(torch.complex64) if dtype == torch.complex64 else x[:, :L]
    x = x.contiguous()
    before = k7.cp_strip.launches
    got = k7.cp_strip(x, n_sym, M + cp, cp)
    ref = k7.cp_strip_reference(x, n_sym, M + cp, cp)
    torch.cuda.synchronize()
    assert k7.cp_strip.launches == before + 1
    assert got.dtype == dtype and got.shape == (S, n_sym, M)
    assert torch.equal(got, ref)  # a copy: bit for bit


@pytest.mark.parametrize("shape,mod", [
    ((2, 40, 2048), Modulation.ARB32OPT), ((2, 40, 1638), Modulation.QAM16),
    ((1, 100, 50), Modulation.QAM256), ((3, 7), Modulation.BPSK)])
def test_demap_kernel_matches_plain(shape, mod):
    dev = require_cuda()
    rng = np.random.default_rng(len(shape) + shape[-1])
    y = torch.as_tensor((rng.standard_normal(shape)
                         + 1j * rng.standard_normal(shape)).astype(
                             np.complex64) * 0.8, device=dev)
    table = constellation.table(mod)
    before = k34.demap.launches
    got = k34.demap(y, table)
    ref = constellation.hard_demap(y, table)
    torch.cuda.synchronize()
    assert k34.demap.launches == before + 1
    assert got.dtype == torch.int32 and got.shape == y.shape
    assert_decisions_match(got, ref, y, table)
    # rows of zeros (inactive streams) decide point 0 on a PSK table
    zeros = torch.zeros((2, 64), dtype=torch.complex64, device=dev)
    assert not k34.demap(zeros, constellation.table(Modulation.QPSK)).any()
    # constellation.demodulate routes CUDA tensors to the kernel
    before = k34.demap.launches
    assert torch.equal(constellation.demodulate(y, mod), got)
    assert k34.demap.launches == before + 1


def _eq_case(dev, S, n_sym, M, seed):
    rng = np.random.default_rng(seed)
    x = torch.as_tensor((rng.standard_normal((S, n_sym, M))
                         + 1j * rng.standard_normal((S, n_sym, M))).astype(
                             np.complex64), device=dev)
    _, _, G = random_tail_inputs(seed, S, M, 0, 1)
    W, gain = zf.invert(torch.as_tensor(G, device=dev))
    return x, W, gain


@pytest.mark.parametrize("S,n_sym,M", [(2, 40, 2048), (2, 9, 100),
                                       (1, 5, 64), (4, 3, 384)])
def test_eq_demap_kernel_matches_plain(S, n_sym, M):
    dev = require_cuda()
    X, W, gain = _eq_case(dev, S, n_sym, M, M + S)
    X = X * np.float32(1.0 / np.sqrt(M))
    table = constellation.table(Modulation.ARB32OPT)
    before = k34.eq_demap.launches
    sig, data = k34.eq_demap(X, W, gain, table)
    ref_sig, ref_data = k34.eq_demap_reference(X, W, gain, table)
    torch.cuda.synchronize()
    assert k34.eq_demap.launches == before + 1
    assert data.shape == (S, n_sym, M) and data.dtype == torch.int32
    rms = float(torch.sqrt(torch.mean(ref_sig.abs() ** 2)))
    assert float((sig - ref_sig).abs().max()) <= 1e-5 * rms
    assert_decisions_match(data, ref_data, ref_sig, table)
    none_sig, d2 = k34.eq_demap(X, W, gain, table, emit_sig=False)
    assert none_sig is None and torch.equal(d2, data)



ALL_MODS = [Modulation.BPSK, Modulation.QPSK, Modulation.QAM16,
            Modulation.QAM64, Modulation.QAM256, Modulation.ARB32OPT]


def _probe(mod, n, seed, dev):
    return torch.as_tensor(k34.probe_symbols(constellation.table(mod), n,
                                             seed), device=dev)


@pytest.mark.parametrize("mod", ALL_MODS)
@pytest.mark.parametrize("n,offset", [(4099, 0), (4099, 1), (5, 1), (1, 0),
                                      (2, 1), (3, 0)])
def test_demap_kernel_by_modulation(mod, n, offset):
    """K4 on symbols that reach every path of the search (cells of one to
    four candidates, cell edges, ties, outside the box, 0, NaN, Inf), at
    a numel that is no multiple of four, from a 16-byte aligned tensor
    and from a slice that is only 8-byte aligned."""
    dev = require_cuda()
    table = constellation.table(mod)
    y = _probe(mod, max(n, 64), n + offset, dev)
    buf = torch.zeros(offset + n, dtype=torch.complex64, device=dev)
    buf[offset:] = y[:n]
    y = buf[offset:]
    assert (y.data_ptr() % 16 != 0) == bool(offset)
    before = k34.demap.launches
    got = k34.demap(y, table)
    ref = constellation.hard_demap(y, table)
    torch.cuda.synchronize()
    assert k34.demap.launches == before + 1
    assert got.dtype == torch.int32 and got.shape == y.shape
    assert_decisions_match(got, ref, y, table)
    assert torch.equal(got, k34.demap_full_scan(y, table))


@pytest.mark.parametrize("mod", ALL_MODS)
def test_region_search_equals_full_scan(mod):
    """The region search decides as the kernel's full scan, bit for bit,
    on K4's symbols (inside and outside the box) and on the symbols K3
    equalizes (its decisions against the full scan of its rx_sig)."""
    dev = require_cuda()
    table = constellation.table(mod)
    y = _probe(mod, 100_003, 5, dev).reshape(1, -1)
    box = float(k34.region_geometry(table)[0])
    inside = torch.maximum(y.real.abs(), y.imag.abs()) < box
    assert 0 < int(inside.sum()) < y.numel()  # both paths taken
    assert torch.equal(k34.demap(y, table), k34.demap_full_scan(y, table))
    if len(table) <= k34.MAX_EQ_POINTS:
        X, W, gain = _eq_case(dev, 2, 9, 1000, 17)
        sig, data = k34.eq_demap(X * np.float32(0.03), W, gain, table)
        assert torch.equal(data, k34.demap_full_scan(sig, table))


@pytest.mark.parametrize("mod", [m for m in ALL_MODS
                                 if m != Modulation.QAM256])
@pytest.mark.parametrize("S,n_sym,M", [(1, 1, 1), (2, 3, 129), (3, 1, 257),
                                       (4, 5, 2048), (2, 1000, 64)])
def test_eq_demap_kernel_by_modulation(mod, S, n_sym, M):
    """K3 with 1-4 streams, odd M and one frame, its equalized symbols
    the probe symbols of the search (X = G y per subcarrier, W gain =
    G^-1), against its plain version; rx_sig within 1e-5 of RMS."""
    dev = require_cuda()
    table = constellation.table(mod)
    _, W, gain = _eq_case(dev, S, 1, M, S + M)
    y = _probe(mod, S * n_sym * M + 64, M, dev)[:S * n_sym * M]
    G = torch.linalg.inv(W * gain[:, None, None])
    X = torch.einsum("mij,jkm->ikm", G, y.reshape(S, n_sym, M)).contiguous()
    X = torch.where(torch.isfinite(X), X, 0)
    before = k34.eq_demap.launches
    sig, data = k34.eq_demap(X, W, gain, table)
    ref_sig, ref_data = k34.eq_demap_reference(X, W, gain, table)
    torch.cuda.synchronize()
    assert k34.eq_demap.launches == before + 1
    rms = float(torch.sqrt(torch.mean(ref_sig.abs() ** 2)))
    assert float((sig - ref_sig).abs().max()) <= 1e-5 * rms
    assert_decisions_match(data, ref_data, ref_sig, table)
    assert torch.equal(data, k34.demap_full_scan(sig, table))


@pytest.mark.parametrize("S,M,n_sym", [(1, 1, 1), (2, 2048, 1000),
                                       (3, 129, 7), (4, 4096, 3),
                                       (2, 64, 100_000)])
def test_eq_demap_geometry(S, M, n_sym):
    """K3's grid is eq_block_plan at the occupancy calculator's blocks per
    SM: every (frame, subcarrier) once (tests/test_torch_demap_plan.py),
    about one wave, with at least 24 warps an SM."""
    dev = require_cuda()
    geo = k34.launch_geometry("eq_demap", S, M, n_sym, device=dev)
    plan = k34.eq_block_plan(M, n_sym, geo["blocks_per_sm"], geo["sms"])
    assert (geo["tiles"], geo["ranges"], geo["threads"]) == (
        plan["tiles"], plan["ranges"], plan["threads"])
    assert geo["blocks_per_sm"] * geo["threads"] >= 768  # 24 warps an SM


@pytest.mark.parametrize("n,head", [(1, 0), (7, 1), (4_096_000, 0),
                                    (4_096_001, 1), (10**9, 0)])
def test_demap_geometry(n, head):
    dev = require_cuda()
    geo = k34.launch_geometry("demap", n, head, device=dev)
    plan = k34.demap_plan(n, head, geo["blocks_per_sm"], geo["sms"])
    assert (geo["per_thread"], geo["grid"]) == (plan["per_thread"],
                                                plan["grid"])
    assert geo["per_thread"] == (4 if n > 10**6 else 1)
    assert geo["threads"] == k34.DEMAP_THREADS

# (S, n_sym, M, modulation, offset of x in complex samples): every M of
# the gate, 1-4 streams, 2-64 points, an unaligned x (8-byte copies)
K2_CASES = {
    "s2_m2048": (2, 40, 2048, A32, 0),
    "s1_m64": (1, 9, 64, A32, 0),
    "s2_m128_bpsk": (2, 7, 128, Modulation.BPSK, 0),
    "s3_m256_qpsk": (3, 5, 256, Modulation.QPSK, 0),
    "s2_m512_qam16": (2, 6, 512, QAM16, 0),
    "s3_m1024": (3, 4, 1024, A32, 0),
    "s4_m4096": (4, 3, 4096, A32, 0),
    "s1_m4096_qam64": (1, 5, 4096, QAM64, 0),
    "s2_m2048_offset1": (2, 9, 2048, A32, 1),
    "s4_m2048_offset1_qam16": (4, 5, 2048, QAM16, 1),
}


@pytest.mark.parametrize("case", list(K2_CASES))
def test_payload_fused_kernel_matches_plain(case):
    dev = require_cuda()
    S, n_sym, M, mod, offset = K2_CASES[case]
    x, W, gain = _eq_case(dev, S, n_sym, M, M + 7 * S)
    if offset:
        buf = torch.zeros(offset + x.numel(), dtype=x.dtype, device=dev)
        buf[offset:] = x.reshape(-1)
        x = buf[offset:].view(x.shape)
    table = constellation.table(mod)
    norm = np.float32(1.0 / np.sqrt(M))
    before = pf.payload_fused.launches
    sig, data = pf.payload_fused(x, W, gain, table, norm)
    ref_sig, ref_data = pf.payload_fused_reference(x, W, gain, table, norm)
    torch.cuda.synchronize()
    assert pf.payload_fused.launches == before + 1
    assert data.shape == (S, n_sym, M) and data.dtype == torch.int32
    rms = float(torch.sqrt(torch.mean(ref_sig.abs() ** 2)))
    assert float((sig - ref_sig).abs().max()) <= 1e-4 * rms
    assert_decisions_match(data, ref_data, ref_sig, table)
    none_sig, d2 = pf.payload_fused(x, W, gain, table, norm, emit_sig=False)
    assert none_sig is None and torch.equal(d2, data)


def test_payload_kernels_reject_what_they_cannot_take():
    dev = require_cuda()
    x, W, gain = _eq_case(dev, 2, 3, 64, 1)
    qpsk = constellation.table(Modulation.QPSK)
    qam256 = constellation.table(Modulation.QAM256)
    norm = np.float32(0.125)
    for call in (
        lambda: pf.payload_fused(x, W.cpu(), gain, qpsk, norm),  # CPU mixed
        lambda: pf.payload_fused(x[:, :, :48].contiguous(), W[:48], gain[:48],
                                 qpsk, norm),                    # M=48
        lambda: pf.payload_fused(x, W, gain, qam256, norm),      # 256 points
        lambda: pf.payload_fused(x.transpose(0, 1), W, gain, qpsk, norm),
        lambda: k34.eq_demap(x, W, gain.cpu(), qpsk),            # CPU mixed
        lambda: k34.eq_demap(x[:1], W, gain, qpsk),              # W shape
        lambda: k34.eq_demap(x, W, gain, qam256),                # 256 points
        lambda: k34.demap(x.real, qpsk),                         # dtype
        lambda: k34.demap(x.transpose(1, 2), qpsk),              # strides
        lambda: k34.demap(x, np.zeros(257, np.complex64)),       # 257 points
        lambda: k7.cp_strip(x[0], 3, 60, 4),                     # too short
        lambda: k7.cp_strip(x.to(torch.complex128)[0], 1, 64, 4),  # dtype
        lambda: k7.cp_strip(x[:, 0, :].t(), 1, 2, 1),            # strides
        lambda: k7.cp_strip(x[0], 1, 64, 64),                    # cp >= sym
    ):
        with pytest.raises(ValueError):
            call()


def _counters():
    return {"k1": pf.payload_fused_strip, "k2": pf.payload_fused,
            "k3": k34.eq_demap, "k4": k34.demap, "k7": k7.cp_strip}


# (config change, capture options, payload_impl, launches of K1 K2 K3 K4
# K7 at TINY (8 frames) and at MID (12 frames))
SISO = dict(num_streams=1, mode=CommMode.SISO, siso_tx=0, siso_rx=0,
            bit_exact=False)
GENERIC_CASES = {
    "fused": (dict(), dict(), "fused", (0, 1, 0, 0, 1), (0, 1, 0, 0, 1)),
    "eqdemap": (dict(), dict(), "eqdemap", (0, 0, 1, 0, 1), (0, 0, 1, 0, 1)),
    "xla": (dict(), dict(), "xla", (0, 0, 0, 1, 1), (0, 0, 0, 1, 1)),
    "guard_bands": (dict(use_all_carriers=False, normalize_rx_scale=True,
                         bit_exact=False), dict(), "auto",
                    (0, 0, 0, 1, 1), (0, 0, 0, 1, 1)),
    "siso": (SISO, dict(identity=True), "auto",
             (0, 0, 0, 1, 1), (0, 0, 0, 1, 1)),
    "rx_diversity": (dict(mode=CommMode.RX_DIVERSITY, bit_exact=False,
                          modulation=Modulation.QAM16), dict(), "auto",
                     (0, 0, 0, 1, 1), (0, 0, 0, 1, 1)),
    "alamouti": (dict(mode=CommMode.ALAMOUTI, bit_exact=False), dict(),
                 "auto", (0, 0, 0, 1, 1), (0, 0, 0, 1, 1)),
    "sic": (dict(detector=Detector.SIC, bit_exact=False), dict(), "auto",
            (0, 0, 0, 3, 1), (0, 0, 0, 3, 1)),
    "ml": (dict(detector=Detector.ML, bit_exact=False,
                modulation=Modulation.QPSK), dict(), "auto",
           (0, 0, 0, 1, 1), (0, 0, 0, 1, 1)),
    "track_channel": (dict(track_channel=True, track_block_frames=4,
                           bit_exact=False), dict(), "auto",
                      (0, 0, 0, 3, 1), (0, 0, 0, 4, 1)),
    "track_phase": (dict(track_phase=True), dict(), "auto",
                    (0, 0, 0, 2, 1), (0, 0, 0, 2, 1)),
    "cfo_generic": (dict(correct_cfo=True, use_all_carriers=False,
                         bit_exact=False), dict(cfo_subcarriers=0.05),
                    "auto", (0, 0, 0, 1, 1), (0, 0, 0, 1, 1)),
}


@pytest.mark.parametrize("case", list(GENERIC_CASES))
@pytest.mark.parametrize("cfg", [TINY, MID], ids=["tiny", "mid"])
def test_generic_tail_decodes_on_card_match_cpu(cfg, case):
    dev = require_cuda()
    change, cap_kw, impl, n_tiny, n_mid = GENERIC_CASES[case]
    cfg = cfg.replace(**change)
    spec = simulator.ChannelSpec(**{**dict(snr_db=30.0, delay=3000, seed=3),
                                    **cap_kw})
    cap, tx, _ = simulator.simulate_capture(cfg, spec, device="cpu")
    on_cpu = rx.make_decoder(cfg, device="cpu", payload_impl=impl)(cap)
    counts = _counters()
    before = {k: c.launches for k, c in counts.items()}
    on_card = rx.make_decoder(cfg, device=dev, input_format="planes",
                              payload_impl=impl)(
        cap.real.contiguous(), cap.imag.contiguous())
    torch.cuda.synchronize()
    got = tuple(c.launches - before[k] for k, c in counts.items())
    assert got == (n_tiny if cfg.M == 64 else n_mid), got
    for f in ("synced", "sync_index", "sync_sample", "plateau_start",
              "plateau_end", "s0_index", "ac_index", "decode_start",
              "rx_data", "symbol_valid"):
        np.testing.assert_array_equal(n(getattr(on_card, f)),
                                      n(getattr(on_cpu, f)), err_msg=f)
    np.testing.assert_allclose(n(on_card.G), n(on_cpu.G), rtol=1e-4,
                               atol=1e-6)
    np.testing.assert_allclose(n(on_card.W), n(on_cpu.W), rtol=1e-4,
                               atol=1e-6)
    scale = float(on_cpu.rx_sig.abs().max())
    np.testing.assert_allclose(n(on_card.rx_sig), n(on_cpu.rx_sig), rtol=0,
                               atol=1e-4 * scale)
    assert (on_card.Y is None) == (cfg.detector != Detector.ML)
    ser = report.score(on_card, tx, cfg).symbol_error_rate
    assert ser == [0.0] * len(ser)


@pytest.mark.parametrize("M,cp,n_sym,pitch", [(2048, 152, 7, 4400),
                                              (64, 16, 9, 160),
                                              (2048, 152, 263, 2200),
                                              (512, 40, 11, 1105)])
def test_kernel_with_pitch_matches_plain_tail(M, cp, n_sym, pitch):
    """K1 with a symbol pitch above M + cp (the sharded decode's stripe
    of every n_sc-th symbol; (2048, 263 frames, 2200) is one (4, 1)
    shard's call, an odd pitch takes the 4-byte copies)."""
    dev = require_cuda()
    args, _ = _tail_case(dev, M, cp, n_sym * pitch // (M + cp) + 1)
    p_re, p_im = (p[:, :n_sym * pitch].contiguous() for p in args[:2])
    args = (p_re, p_im) + args[2:]
    kw = dict(n_sym=n_sym, symbol_len=pitch, cp_len=cp, M=M)
    sig, data = pf.payload_fused_strip(*args, **kw)
    ref_sig, ref_data = pf.payload_tail_reference(*args, **kw)
    torch.cuda.synchronize()
    assert data.shape == (2, n_sym, M)
    assert_decisions_match(data, ref_data, ref_sig, args[4])
    rms = float(torch.sqrt(torch.mean(ref_sig.abs() ** 2)))
    assert float((sig - ref_sig).abs().max()) <= 1e-4 * rms


@pytest.mark.parametrize("shape,H", [((2, 1), 129), ((4, 1), 129),
                                     ((8, 1), 129), ((4, 2), 129),
                                     ((4, 1), 2047)])
def test_halo_kernel_matches_plain(shape, H):
    dev = require_cuda()
    n_time, n_sc = shape
    m = pmesh.make_mesh(n_time, n_sc, devices=[dev] * (n_time * n_sc))
    rng = np.random.default_rng(H + n_time + n_sc)
    blocks = [[torch.as_tensor(
        (rng.standard_normal((2, 3 * H)) + 1j * rng.standard_normal(
            (2, 3 * H))).astype(np.complex64), device=dev)
        for _ in range(n_sc)] for _ in range(n_time)]
    for parts in ([[b[:, -H:] for b in row] for row in blocks],  # strided
                  [[b[:, :H].contiguous() for b in row] for row in blocks]):
        before = k8.ring_shift_right.launches
        got = k8.ring_shift_right(parts, m)
        ref = k8.ring_shift_right_reference(parts, m)
        torch.cuda.synchronize()
        assert k8.ring_shift_right.launches == before + 1
        for t in range(n_time):
            for s in range(n_sc):
                assert got[t][s].is_cuda
                assert torch.equal(got[t][s], ref[t][s]), (t, s)


def test_halo_kernel_rejects_what_it_cannot_take():
    dev = require_cuda()
    m = pmesh.make_mesh(2, 1, devices=[dev] * 2)
    x = torch.zeros((2, 8), dtype=torch.complex64, device=dev)
    for parts in ([[x.to(torch.complex128)], [x.to(torch.complex128)]],
                  [[x], [x[:, :4]]],
                  [[x.t()], [x.t()]],
                  [[x], [x.cpu()]]):
        with pytest.raises(ValueError):
            k8.ring_shift_right(parts, m)
    big = pmesh.make_mesh(65, 1, devices=[dev] * 65)
    with pytest.raises(ValueError, match="at most"):
        k8.ring_shift_right([[x]] * 65, big)


def _rows_with_halo_views(devices, S, H, T):
    """Stage A's row buffers, one [S, H + T] row a shard on its device,
    filled with 7; returns (rows, the [S, H] halo column views)."""
    rows = [torch.full((S, H + T), 7.0, dtype=torch.complex64, device=d)
            for d in devices]
    return rows, [r[:, :H] for r in rows]


@pytest.mark.parametrize("cards", [1, 2], ids=["one_card", "across_cards"])
def test_halo_kernel_writes_into_stage_a_rows(cards):
    """ring_shift_right(..., out=) writes each received halo straight into
    the [S, H] halo columns of a row buffer (row stride H + T), on one
    card and with the shards cycling over the cards; the rest of each row
    stays as it was."""
    devs = require_cuda_devices(cards)[:cards]
    n_time, S, H, T = 4, 2, 2047, 3000
    flat = [devs[t % cards] for t in range(n_time)]
    m = pmesh.make_mesh(n_time, 1, devices=flat)
    blocks = _halo_grid(m.devices, (n_time, 1), H, 60 + cards)
    parts = [[b[:, -H:] for b in row] for row in blocks]
    rows, views = _rows_with_halo_views(flat, S, H, T)
    out = [[v] for v in views]
    before = k8.ring_shift_right.launches
    got = k8.ring_shift_right(parts, m, out=out)
    for d in devs:
        torch.cuda.synchronize(d)
    assert k8.ring_shift_right.launches - before == cards
    ref = k8.ring_shift_right_reference(parts, m)
    for t in range(n_time):
        assert got[t][0].data_ptr() == views[t].data_ptr()
        assert torch.equal(rows[t][:, :H], ref[t][0].to(flat[t])), t
        assert bool((rows[t][:, H:] == 7).all()), t


def test_make_mesh_takes_the_cuda_devices():
    require_cuda()
    m = pmesh.make_mesh()
    assert m.devices.size == torch.cuda.device_count()
    assert all(d.type == "cuda" for d in m.devices.flat)


# (halo_impl, mesh shape, launches of K1, K8, K6 per decode)
SHARDED_CASES = {
    "ppermute_4x1": ("ppermute", (4, 1), (4, 0, 0)),
    "pallas_dma_4x1": ("pallas_dma", (4, 1), (4, 1, 1)),
    "ppermute_2x2": ("ppermute", (2, 2), (4, 0, 0)),
}


@pytest.mark.parametrize("case", list(SHARDED_CASES))
def test_sharded_decode_on_card_matches_single_device(case):
    dev = require_cuda()
    halo_impl, shape, want = SHARDED_CASES[case]
    cap = _capture(MID, delay=3000, seed=3)
    single = rx.make_decoder(MID, device=dev)(cap)
    m = pmesh.make_mesh(*shape, devices=[dev] * 4)
    re, im = pmesh.shard_capture_planes(cap, m)
    dec = ds.build_sharded_decoder(MID, m, shape[0] * re[0][0].shape[1],
                                   halo_impl=halo_impl,
                                   input_format="planes")
    counts = (pf.payload_fused_strip, k8.ring_shift_right, k6.sc_metric_fused)
    before = [c.launches for c in counts]
    got = dec(re, im)
    torch.cuda.synchronize()
    assert tuple(c.launches - b for c, b in zip(counts, before)) == want
    for f in ("synced", "sync_index", "sync_sample", "decode_start"):
        assert int(getattr(got, f)) == int(getattr(single, f)), f
    assert got.rx_data.is_cuda and got.G.is_cuda
    np.testing.assert_allclose(n(got.G), n(single.G), rtol=2e-4, atol=2e-5)
    assert_decisions_match(got.rx_data, single.rx_data, single.rx_sig,
                           constellation.table(MID.modulation))


def _ser_zero(rx_data: torch.Tensor, tx, cfg) -> bool:
    """Every stream's decisions equal the transmitted symbols (RX_ZF)."""
    k = cfg.pid_max * cfg.M_occupied
    got, want = n(rx_data)[:, :k], np.asarray(tx)[:, :k]
    return bool((got == want).all())


# (halo_impl, mesh shape, launches of K1, K8, K6 per decode) on
# make_mesh()'s own four cards, one shard per card: K8 runs once per card
# of the "sc" column 0 (a (2, 2) mesh's spans cards 0 and 2), K6 once per
# card of that column
ACROSS_CASES = {
    "ppermute_4x1": ("ppermute", (4, 1), (4, 0, 0)),
    "pallas_dma_4x1": ("pallas_dma", (4, 1), (4, 4, 4)),
    "pallas_dma_2x2": ("pallas_dma", (2, 2), (4, 2, 2)),
}


@pytest.mark.parametrize("case", list(ACROSS_CASES))
def test_sharded_decode_across_cards_matches_single_device(case):
    """The sharded decode on make_mesh()'s own devices, one shard per
    card, against the single decode of the same capture by PERF.md's
    "sharded = single" rules, with SER 0: K1 runs on each card, and with
    "pallas_dma" K8 pulls each halo from the left neighbour's card."""
    devs = require_cuda_devices(4)
    halo_impl, shape, want = ACROSS_CASES[case]
    spec = simulator.ChannelSpec(snr_db=30.0, delay=3000, seed=3)
    cap, tx, _ = simulator.simulate_capture(MID, spec, device="cpu")
    single = rx.make_decoder(MID, device=devs[0])(cap)
    m = pmesh.make_mesh(*shape)
    assert [d.index for d in m.devices.flat] == [0, 1, 2, 3]
    re, im = pmesh.shard_capture_planes(cap, m)
    dec = ds.build_sharded_decoder(MID, m, shape[0] * re[0][0].shape[1],
                                   halo_impl=halo_impl,
                                   input_format="planes")
    counts = (pf.payload_fused_strip, k8.ring_shift_right, k6.sc_metric_fused)
    before = [c.launches for c in counts]
    got = dec(re, im)
    for d in devs:
        torch.cuda.synchronize(d)
    assert tuple(c.launches - b for c, b in zip(counts, before)) == want
    for f in ("synced", "sync_index", "sync_sample", "decode_start"):
        assert int(getattr(got, f)) == int(getattr(single, f)), f
    assert got.G.device == devs[0] and got.rx_data.device == devs[0]
    np.testing.assert_allclose(n(got.G), n(single.G), rtol=2e-4, atol=2e-5)
    assert_decisions_match(got.rx_data, single.rx_data, single.rx_sig,
                           constellation.table(MID.modulation))
    assert _ser_zero(got.rx_data, tx, MID)


def _halo_grid(devices, shape, H, seed):
    """Seeded [2, 3H] complex64 blocks, block (t, s) on devices[t, s]."""
    rng = np.random.default_rng(seed)
    n_time, n_sc = shape
    return [[torch.as_tensor(
        (rng.standard_normal((2, 3 * H)) + 1j * rng.standard_normal(
            (2, 3 * H))).astype(np.complex64), device=devices[t, s])
        for s in range(n_sc)] for t in range(n_time)]


@pytest.mark.parametrize("H", [129, 2047])
@pytest.mark.parametrize("shape", [(2, 1), (4, 1), (4, 2)],
                         ids=["2x1", "4x1", "4x2"])
def test_halo_kernel_across_cards_matches_plain(shape, H):
    """K8 on meshes whose shards cycle over the cards: one launch per
    card, each halo pulled from the left neighbour's card bit for bit."""
    devs = require_cuda_devices(2)
    n_time, n_sc = shape
    flat = [devs[i % len(devs)] for i in range(n_time * n_sc)]
    m = pmesh.make_mesh(n_time, n_sc, devices=flat)
    blocks = _halo_grid(m.devices, shape, H, H + n_time + n_sc)
    for parts in ([[b[:, -H:] for b in row] for row in blocks],  # strided
                  [[b[:, :H].contiguous() for b in row] for row in blocks]):
        before = k8.ring_shift_right.launches
        got = k8.ring_shift_right(parts, m)
        ref = k8.ring_shift_right_reference(parts, m)
        for d in devs:
            torch.cuda.synchronize(d)
        assert k8.ring_shift_right.launches - before == len(set(flat))
        for t in range(n_time):
            for s in range(n_sc):
                assert got[t][s].device == m.devices[t, s]
                assert torch.equal(got[t][s],
                                   ref[t][s].to(got[t][s].device)), (t, s)


def test_halo_kernel_across_cards_orders_the_source():
    """K8's read is held back by a sleep queued on each destination
    card's stream; meanwhile the source halos are freed and fresh
    allocations of the same size on the source cards (the caching
    allocator hands back the freed blocks) are overwritten.  The halos
    received must still be the sources' values: the source card's stream
    waits for the read before the overwrite."""
    devs = require_cuda_devices(2)
    m = pmesh.make_mesh(len(devs), 1, devices=devs)
    S, H = 2, 2047
    rng = np.random.default_rng(50)
    reused = 0
    for _ in range(50):
        vals = [torch.as_tensor((rng.standard_normal((S, H))
                                 + 1j * rng.standard_normal((S, H)))
                                .astype(np.complex64)) for _ in devs]
        parts = [[v.to(d)] for v, d in zip(vals, devs)]
        ptrs = {p[0].data_ptr() for p in parts[:-1]}
        for d in devs[1:]:
            with torch.cuda.device(d):
                torch.cuda._sleep(2_000_000)
        got = k8.ring_shift_right(parts, m)
        del parts
        junk = [torch.empty((S, H), dtype=torch.complex64, device=d)
                for d in devs[:-1] for _ in range(4)]
        for j in junk:
            torch.view_as_real(j).fill_(-7.0)
        reused += sum(j.data_ptr() in ptrs for j in junk)
        for d in devs:
            torch.cuda.synchronize(d)
        assert not got[0][0].any()
        for t in range(1, len(devs)):
            assert torch.equal(got[t][0].cpu(), vals[t - 1]), t
        del junk
    assert reused > 0  # the overwrites did land on freed source blocks


def test_sharded_serving_across_cards_matches_single_decodes():
    """Batched serving of 8 captures on make_mesh(4, 1), two per card,
    each against its single decode; results on the home card."""
    from rub_mimo_tpu_torch.parallel import serving

    devs = require_cuda_devices(4)
    m = pmesh.make_mesh(4, 1)
    caps, txs = [], []
    # channel seeds whose MID captures decode with SER 0 (25, 29 and 36
    # give a few errors at 30 dB, in the single decode as well)
    for seed in (20, 21, 22, 23, 24, 26, 27, 28):
        spec = simulator.ChannelSpec(snr_db=30.0, delay=3000, seed=seed)
        cap, tx, _ = simulator.simulate_capture(MID, spec, device="cpu")
        caps.append(cap)
        txs.append(tx)
    dec = serving.make_sharded_batch_decoder(MID, m)
    before = pf.payload_fused_strip.launches
    got = dec(serving.shard_batch(torch.stack(caps), m))
    for d in devs:
        torch.cuda.synchronize(d)
    assert pf.payload_fused_strip.launches - before == 8
    assert got.rx_data.device == devs[0] and got.G.device == devs[0]
    single = rx.make_decoder(MID, device=devs[0])
    for i, cap in enumerate(caps):
        ref = single(cap)
        for f in ("synced", "sync_index", "sync_sample", "decode_start"):
            assert torch.equal(getattr(got, f)[i], getattr(ref, f)), (i, f)
        np.testing.assert_allclose(n(got.G[i]), n(ref.G), rtol=2e-4,
                                   atol=2e-5)
        assert_decisions_match(got.rx_data[i], ref.rx_data, ref.rx_sig,
                               constellation.table(MID.modulation))
        assert _ser_zero(got.rx_data[i], txs[i], MID)


# the paths make_serving_decoder serves from CUDA graphs, at MID's
# widths: (config, channel, decoder options, launches per decode of K5
# K6 K1 K7 K4)
_SERVE_SPEC = dict(snr_db=30.0, delay=3000, seed=3)
SERVED_PATHS = {
    "operating_point": (MID, _SERVE_SPEC, dict(sync_impl="pallas"),
                        (1, 0, 1, 0, 0)),
    "cfo_config": (MID.replace(correct_cfo=True, sync_fallback=True,
                               smooth_channel=True),
                   dict(_SERVE_SPEC, cfo_subcarriers=0.05),
                   dict(sync_impl="pallas"), (1, 0, 1, 0, 0)),
    "mimo_2x2_zf_xla": (MID.replace(modulation=Modulation.QAM16),
                        _SERVE_SPEC,
                        dict(sync_impl="pallas", payload_impl="xla"),
                        (1, 0, 0, 1, 1)),
    "track_channel": (MID.replace(track_channel=True, track_block_frames=4),
                      _SERVE_SPEC, dict(sync_impl="pallas"),
                      (1, 0, 0, 1, 4)),
    "mimo_4x4_wideband": (MID.replace(num_streams=4,
                                      modulation=Modulation.QAM16,
                                      detector=Detector.MMSE,
                                      mmse_noise_var=1e-3, sync_quorum=3),
                          dict(snr_db=35.0, delay=3000, seed=6),
                          dict(sync_impl="xla"), (0, 1, 1, 0, 0)),
}


def _served_captures(path: str, seeds=(0, 1)):
    """The path's captures with the channel seed moved by each of
    ``seeds``: (planes stacks [B, S, T] on the card, tx data)."""
    cfg, spec, _, _ = SERVED_PATHS[path]
    caps, txs = [], []
    for k in seeds:
        s = simulator.ChannelSpec(**dict(spec, seed=spec["seed"] + k))
        cap, tx, _ = simulator.simulate_capture(cfg, s, device="cpu")
        caps.append(cap)
        txs.append(tx)
    T = min(c.shape[-1] for c in caps)
    stack = torch.stack([c[:, :T] for c in caps]).to("cuda")
    return (stack.real.contiguous(), stack.imag.contiguous()), txs


def _serve_counts():
    return (k5.sc_sync_fused, k6.sc_metric_fused, pf.payload_fused_strip,
            k7.cp_strip, k34.demap)


@pytest.mark.parametrize("path", list(SERVED_PATHS))
def test_graph_served_decodes_match_eager(path):
    """Each capture served from the path's CUDA graph equals the eager
    decode of it with the same options (integers equal, G and rx_sig
    within 1e-4), with SER 0; the first call warms up twice and captures
    once, and a replay launches through no wrapper."""
    require_cuda()
    cfg, _, kw, per_decode = SERVED_PATHS[path]
    planes, txs = _served_captures(path)
    serve = rx.make_serving_decoder(cfg, device="cuda",
                                    input_format="planes", **kw)
    before = [c.launches for c in _serve_counts()]
    got = serve(*planes)
    mid = [c.launches for c in _serve_counts()]
    again = serve(*planes)
    torch.cuda.synchronize()
    assert [m - b for m, b in zip(mid, before)] == [
        (rx.WARMUP_DECODES + 1) * k for k in per_decode]
    assert [c.launches for c in _serve_counts()] == mid
    assert len(serve.graphs) == 1
    eager = rx.make_decoder(cfg, device="cuda", input_format="planes", **kw)
    for i, tx in enumerate(txs):
        ref = eager(planes[0][i], planes[1][i])
        for f in ("synced", "sync_index", "sync_sample", "plateau_start",
                  "plateau_end", "s0_index", "ac_index", "decode_start",
                  "rx_data", "symbol_valid"):
            assert torch.equal(getattr(got, f)[i], getattr(ref, f)), (i, f)
            assert torch.equal(getattr(again, f)[i], getattr(ref, f)), (i, f)
        np.testing.assert_allclose(n(got.G[i]), n(ref.G), rtol=1e-4,
                                   atol=1e-6)
        scale = float(ref.rx_sig.abs().max())
        np.testing.assert_allclose(n(got.rx_sig[i]), n(ref.rx_sig), rtol=0,
                                   atol=1e-4 * scale)
        assert got.metric is None and got.mf_traces is None
        ser = report.score(_one(got, i), tx, cfg).symbol_error_rate
        assert ser == [0.0] * len(ser), (i, ser)


def _one(stacked, i: int):
    return stacked._replace(**{f: v[i] for f, v in stacked._asdict().items()
                               if v is not None})


@pytest.mark.parametrize("path", list(SERVED_PATHS))
def test_served_paths_do_not_synchronize(path):
    """An eager decode of each served path raises nothing under
    torch.cuda.set_sync_debug_mode("error"), which does raise on a
    host read."""
    require_cuda()
    cfg, _, kw, _ = SERVED_PATHS[path]
    planes, _ = _served_captures(path, seeds=(0,))
    dec = rx.make_decoder(cfg, device="cuda", input_format="planes", **kw)
    dec(planes[0][0], planes[1][0])  # warm: plans, caches, attributes
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        with pytest.raises(RuntimeError):
            int(planes[0].sum())
        r = dec(planes[0][0], planes[1][0])
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert bool(r.synced)


def test_second_replay_serves_its_own_capture():
    """Two captures served one at a time through the same graph: each
    result is that capture's decode, and the first result is not
    overwritten by the second replay; a noise-only capture is served
    too (no sync, its garbage decode equal to the eager one)."""
    require_cuda()
    cfg, _, kw, _ = SERVED_PATHS["operating_point"]
    planes, _ = _served_captures("operating_point")
    rng = np.random.default_rng(5)
    noise = torch.as_tensor(rng.standard_normal(
        (2,) + tuple(planes[0].shape[1:])).astype(np.float32) * 0.05,
        device="cuda")
    serve = rx.make_serving_decoder(cfg, device="cuda",
                                    input_format="planes", **kw)
    eager = rx.make_decoder(cfg, device="cuda", input_format="planes", **kw)
    first = serve(planes[0][:1], planes[1][:1])
    first_data = first.rx_data.clone()
    second = serve(planes[0][1:], planes[1][1:])
    quiet = serve(noise[0][None], noise[1][None])
    assert len(serve.graphs) == 1
    assert torch.equal(first.rx_data, first_data)
    for got, (re, im) in ((first, (planes[0][0], planes[1][0])),
                          (second, (planes[0][1], planes[1][1])),
                          (quiet, (noise[0], noise[1]))):
        ref = eager(re, im)
        for f in ("synced", "sync_index", "decode_start", "ac_index",
                  "rx_data", "symbol_valid"):
            assert torch.equal(getattr(got, f)[0], getattr(ref, f)), f
    assert not bool(quiet.synced[0])
    assert not torch.equal(first.G, second.G)  # two channels


# the streaming decoder at MID's widths: (config, chunk, chunks a
# push_block call (1: push), the kernels each run must launch)
_STREAM_SPEC = simulator.ChannelSpec(snr_db=30.0, delay=3000, seed=3)
STREAM_PATHS = {
    "push": (MID, 16384, 1, ("sc_metric_fused", "payload_fused_strip",
                             "demap")),
    "push_block": (MID, 16384, 4, ("sc_metric_fused", "payload_fused_strip",
                                   "demap")),
    "guard_bands": (MID.replace(use_all_carriers=False), 16384, 1,
                    ("sc_metric_fused", "cp_strip", "demap")),
    "track_channel": (MID.replace(track_channel=True, track_block_frames=4),
                      16384, 1, ("sc_metric_fused", "cp_strip", "demap")),
}


def _stream(dec, cap: torch.Tensor, block: int) -> None:
    """Push cap through dec, ``block`` chunks a call, then finalize."""
    n = block * dec.C
    calls = -(-cap.shape[-1] // n)
    x = torch.nn.functional.pad(cap, (0, calls * n - cap.shape[-1]))
    for i in range(calls):
        piece = x[:, i * n:(i + 1) * n]
        (dec.push if block == 1 else dec.push_block)(piece)
    dec.finalize()


@pytest.mark.parametrize("path", list(STREAM_PATHS))
def test_streamed_decode_matches_eager(path):
    """A capture streamed on the card equals the port's eager decode of
    it in every integer (sync_index, the global decode_start, rx_data),
    with SER 0, and the path launched its kernels: K6 in the seek, K1 in
    the payload blocks and K4 in result(), or K7 and K4 where K1 does not
    apply (guard bands; track_channel, whose groups decide with K4)."""
    require_cuda()
    cfg, C, block, kernels = STREAM_PATHS[path]
    cap, tx, _ = simulator.simulate_capture(cfg, _STREAM_SPEC, device="cuda")
    ref = rx.make_decoder(cfg, device="cuda")(cap)
    wrappers = {"sc_metric_fused": k6.sc_metric_fused,
                "payload_fused_strip": pf.payload_fused_strip,
                "cp_strip": k7.cp_strip, "demap": k34.demap}
    before = {k: w.launches for k, w in wrappers.items()}
    dec = streaming.StreamingDecoder(cfg, device="cuda", chunk_size=C)
    _stream(dec, cap, block)
    rx_sig, rx_data = dec.result()
    torch.cuda.synchronize()
    ran = {k: w.launches - before[k] for k, w in wrappers.items()}
    assert all(ran[k] >= 1 for k in kernels), ran
    assert dec.synced and dec.sync_index == int(ref.sync_index)
    assert dec.decode_start == (int(ref.sync_index) - cfg.symbol_len
                                + int(ref.decode_start))
    assert rx_data.device.type == "cuda" and rx_sig.dtype == torch.complex64
    assert torch.equal(rx_data, ref.rx_data)
    ser = report.score(ref._replace(rx_data=rx_data), tx,
                       cfg).symbol_error_rate
    assert ser == [0.0] * len(ser)


def test_streamed_payload_does_not_synchronize():
    """Payload-phase pushes raise nothing under
    torch.cuda.set_sync_debug_mode("error"), which does raise on a host
    read (chunks of 4096, the payload's 12 frames over several pushes)."""
    require_cuda()
    cfg, C = MID, 4096
    cap, _, _ = simulator.simulate_capture(cfg, _STREAM_SPEC, device="cuda")
    calls = -(-cap.shape[-1] // C)
    x = torch.nn.functional.pad(cap, (0, calls * C - cap.shape[-1]))
    chunks = [x[:, i * C:(i + 1) * C] for i in range(calls)]
    dec = streaming.StreamingDecoder(cfg, device="cuda", chunk_size=C)
    while dec.phase != "payload":
        dec.push(chunks.pop(0))
    torch.cuda.synchronize()
    checked = 0
    torch.cuda.set_sync_debug_mode("error")
    try:
        with pytest.raises(RuntimeError):
            int(cap[0, 0].real)
        while dec.gpos + 2 * C < dec._burst_end:
            dec.push(chunks.pop(0))
            checked += 1
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert checked >= 1


# ---- the Viterbi kernel, the coded chain and the SFO paths ----
def viterbi_pairs(seed: int, rows: int, T: int) -> torch.Tensor:
    """Seeded LLR pairs [rows, T, 2] with exact ties (zero stretches) and
    +-1e4 pad-level stretches."""
    rng = np.random.default_rng(seed)
    p = (rng.standard_normal((rows, T, 2)) * 2.0).astype(np.float32)
    p[:, T // 5:T // 5 + 40] = 0.0
    p[:, T // 2:T // 2 + 20] = 1e4
    p[::2, T // 2 + 20:T // 2 + 30] = -1e4
    return torch.as_tensor(p)


@pytest.mark.parametrize("rows,T", [(1, 1), (3, 31), (5, 33), (37, 700),
                                    (9, 4352), (2, 100), (7, 64),
                                    (2500, 4352)])
def test_viterbi_kernel_matches_plain(rows, T):
    """Bit for bit with viterbi_plain in both modes (pinned rows and
    uniform-prior windows mixed in one launch), one launch counted; row
    counts that leave a warp's lane groups part empty, and the operating
    point's 2,500 windows of 4,352 steps."""
    dev = require_cuda()
    from rub_mimo_tpu_torch.kernels import viterbi as kv

    pairs = viterbi_pairs(rows * 1000 + T, rows, T)
    pinned = torch.arange(rows) % 2 == 0
    want = kv.viterbi_plain(pairs, pinned)
    before = kv.viterbi.launches
    got = kv.viterbi(pairs.to(dev), pinned.to(dev))
    torch.cuda.synchronize()
    assert kv.viterbi.launches == before + 1
    assert got.dtype == torch.int32 and got.device.type == "cuda"
    assert torch.equal(got.cpu(), want)
    zeros = torch.zeros((2, 100, 2))  # every comparison a tie
    both = torch.tensor([True, False])
    assert torch.equal(kv.viterbi(zeros.to(dev), both.to(dev)).cpu(),
                       kv.viterbi_plain(zeros, both))


def test_viterbi_kernel_rejects_what_it_cannot_take():
    dev = require_cuda()
    from rub_mimo_tpu_torch.kernels import viterbi as kv

    ok = torch.zeros((2, 8, 2), device=dev)
    flags = torch.zeros(2, dtype=torch.bool, device=dev)
    for bad in (ok.double(), ok[:, :, :1].contiguous(), ok.transpose(0, 1),
                torch.zeros((2, 0, 2), device=dev)):
        with pytest.raises(ValueError):
            kv.viterbi(bad, flags[:bad.shape[0]])
    with pytest.raises(ValueError):
        kv.viterbi(ok, flags.cpu())


@pytest.mark.parametrize("rate", ["1/2", "3/4"])
def test_coded_decode_on_card_matches_cpu(rate):
    """encode_payload -> capture -> decode -> decode_payload on the card
    equals the same chain on the CPU (windowed: 260 frames of QPSK at M =
    64 exceed 4 x 4096 steps), BER 0, the soft-LLR rows kernel and the
    Viterbi launched once each."""
    dev = require_cuda()
    from rub_mimo_tpu_torch.kernels import viterbi as kv
    from rub_mimo_tpu_torch.ofdm import fec

    cfg = tiny_config(bit_exact=False, pid_max=260)
    msg, txd = fec.encode_payload(cfg, seed=5, rate=rate)
    spec = simulator.ChannelSpec(snr_db=20.0, delay=300, seed=3)
    cap, _, _ = simulator.simulate_capture(cfg, spec, tx_data=txd,
                                           device="cpu")
    cpu = fec.decode_payload(rx.make_decoder(cfg, device="cpu")(cap).rx_sig,
                             cfg, rate=rate)
    from rub_mimo_tpu_torch.kernels import soft_llr as ks

    before, llr_before = kv.viterbi.launches, ks.soft_llr_rows.launches
    card = fec.decode_payload(rx.make_decoder(cfg, device=dev)(cap).rx_sig,
                              cfg, rate=rate)
    assert kv.viterbi.launches == before + 1
    assert ks.soft_llr_rows.launches == llr_before + 1
    assert card.device.type == "cuda"
    assert torch.equal(card.cpu(), cpu)
    assert np.array_equal(n(card), msg)


def llr_symbols(mod: Modulation, n: int) -> np.ndarray:
    """Seeded symbols around the table, with NaN, +-Inf, 1e30 and
    on-point rows where there is room."""
    t = constellation.table(mod)
    rng = np.random.default_rng(n + len(t))
    y = ((rng.standard_normal(n) + 1j * rng.standard_normal(n)) * 0.8
         ).astype(np.complex64)
    if n >= 8:
        y[:8] = [np.nan, np.inf, -np.inf, 1e30, complex(np.inf, np.nan),
                 complex(0.0, -np.inf), -1e30, t[-1]]
    return y


def same_llrs(a: torch.Tensor, b: torch.Tensor) -> bool:
    return a.shape == b.shape and bool(
        ((a == b) | (torch.isnan(a) & torch.isnan(b))).all())


@pytest.mark.parametrize("n", [1, 4097, 100_003])
@pytest.mark.parametrize("mod", ALL_MODS)
def test_soft_llr_kernel_matches_plain(mod, n):
    """The soft-LLR kernel equals soft_llr_plain on the card value for
    value (NaN where it is NaN), noise_var a number (rounded to float32),
    a device tensor and a CPU scalar tensor; one launch a call."""
    dev = require_cuda()
    from rub_mimo_tpu_torch.kernels import soft_llr as ks

    tab = constellation.table(mod)
    y = torch.as_tensor(llr_symbols(mod, n), device=dev)
    for nv in (1.0, 0.37, 1e-6, torch.tensor(0.37, device=dev),
               torch.tensor(0.37), 0.0, torch.tensor(-2.0, device=dev)):
        before = ks.soft_llr.launches
        got = ks.soft_llr(y, tab, nv)
        torch.cuda.synchronize()
        assert ks.soft_llr.launches == before + 1
        assert got.device.type == "cuda" and got.dtype == torch.float32
        assert same_llrs(got, ks.soft_llr_plain(y, tab, nv)), nv
    shaped = y[: n - n % 2].reshape(2, -1) if n > 1 else y.reshape(1, 1)
    assert same_llrs(constellation.soft_demodulate_llr(shaped, mod, 0.5),
                     ks.soft_llr_plain(shaped, tab, 0.5))


def magnitude_symbols(tab: np.ndarray, n: int, seed: int) -> np.ndarray:
    """n symbols of log-uniform magnitude 2^-20 to 2^20 (inside the
    kernel's fast range, 2^-16 to 2^16, and past it on both sides), an
    eighth real-valued and an eighth imaginary (a coordinate 0), then the
    points themselves, the midpoints of neighbours (ties) and the points
    moved by 2^-30 to 2^-8."""
    rng = np.random.default_rng(seed)
    y = (2.0 ** rng.uniform(-20, 20, n)
         * np.exp(2j * np.pi * rng.uniform(size=n))).astype(np.complex64)
    y[: n // 8] = y[: n // 8].real
    y[n // 8: n // 4] = 1j * y[n // 8: n // 4].imag
    k = len(tab)
    y[n // 4: n // 4 + k] = tab
    y[n // 4 + k: n // 4 + 2 * k - 1] = (tab[1:] + tab[:-1]) / 2
    m = n // 4 + 2 * k
    near = tab[rng.integers(0, k, 4096)] + (
        2.0 ** rng.uniform(-30, -8, 4096)
        * np.exp(2j * np.pi * rng.uniform(size=4096)))
    y[m: m + 4096] = near.astype(np.complex64)
    return y


@pytest.mark.parametrize("mod", ALL_MODS)
def test_soft_llr_kernel_fast_path_across_magnitudes(mod):
    """The kernel's fast path (no hypotf: the square root of a half's least
    fma(max, max, min * min)) and its rare path, value for value against
    soft_llr_plain on 2^20 symbols of magnitudes 2^-20 to 2^20, with a
    coordinate 0, on the points, at ties and 2^-30 to 2^-8 off the points
    (magnitude_symbols); BPSK holds each point's hypotf by itself."""
    dev = require_cuda()
    from rub_mimo_tpu_torch.kernels import soft_llr as ks

    tab = constellation.table(mod)
    y = torch.as_tensor(magnitude_symbols(tab, 1 << 20, len(tab) + 17),
                        device=dev)
    for nv in (0.37, torch.tensor(0.37, device=dev)):
        got = ks.soft_llr(y, tab, nv)
        assert same_llrs(got, ks.soft_llr_plain(y, tab, nv)), nv


def test_soft_llr_kernel_rejects_what_it_cannot_take():
    dev = require_cuda()
    from rub_mimo_tpu_torch.kernels import soft_llr as ks

    tab = constellation.table(Modulation.QPSK)
    y = torch.zeros(16, dtype=torch.complex64, device=dev)
    with pytest.raises(ValueError):
        ks.soft_llr(y.to(torch.complex128), tab)
    with pytest.raises(ValueError):
        ks.soft_llr(y, np.zeros(512, np.complex64))
    with pytest.raises(ValueError):
        ks.soft_llr(y, tab, torch.ones(2, device=dev))
    assert ks.soft_llr(y[:0], tab).shape == (0, 2)


ROW_RATES = ("1/2", "2/3", "3/4")


def row_plans(n: int, rate: str):
    """RowPlans over lanes of n LLRs at ``rate``: the longest codeword the
    lanes hold, interleaved (the smallest stride >= 127 coprime to n) or
    not, one pinned row or windows of 4096 steps."""
    from rub_mimo_tpu_torch.kernels import soft_llr as ks
    from rub_mimo_tpu_torch.ofdm import fec

    used = 2 * (n // 2)
    while fec._kept_bits(used, rate) > n:
        used -= 2
    while fec._kept_bits(used + 2, rate) <= n:
        used += 2
    return [ks.RowPlan(used=used, rate=rate, stride=stride, window=window)
            for stride in (fec.interleave_stride(n, 127), 1)
            for window in (None, 4096)]


@pytest.mark.parametrize("rate", ROW_RATES)
@pytest.mark.parametrize("mod", ALL_MODS)
def test_soft_llr_rows_kernel_matches_plain(mod, rate):
    """The soft-LLR rows kernel equals soft_llr_rows_plain on the card
    value for value (NaN where it is NaN) on 2 lanes of 20,001 seeded
    symbols with NaN, +-Inf and 1e30 rows: interleaved or not, one pinned
    row (several tiles) or windows of 4096, noise_var a number, a device
    tensor and a CPU scalar tensor (and 0, the per-point path); the
    LLR-input instance on the same LLRs; one launch a call."""
    dev = require_cuda()
    from rub_mimo_tpu_torch.kernels import soft_llr as ks

    tab = constellation.table(mod)
    y = torch.as_tensor(np.stack([llr_symbols(mod, 20_001),
                                  llr_symbols(mod, 20_001)[::-1]]),
                        device=dev)
    n = y.shape[1] * mod.bits_per_symbol
    for plan in row_plans(n, rate):
        for nv in (0.37, torch.tensor(0.37, device=dev), torch.tensor(0.37),
                   0.0):
            before = ks.soft_llr_rows.launches
            got, pin = ks.soft_llr_rows(y, plan, tab, nv)
            torch.cuda.synchronize()
            assert ks.soft_llr_rows.launches == before + 1
            want, want_pin = ks.soft_llr_rows_plain(y, plan, tab, nv)
            assert same_llrs(got, want), (plan, nv)
            assert torch.equal(pin, want_pin) and pin.device.type == "cuda"
        llrs = ks.soft_llr_plain(y, tab, 0.37).reshape(2, -1)
        got, _ = ks.soft_llr_rows(llrs, plan)
        assert same_llrs(got, ks.soft_llr_rows_plain(llrs, plan)[0]), plan


def test_soft_llr_rows_kernel_rejects_what_it_cannot_take():
    dev = require_cuda()
    from rub_mimo_tpu_torch.kernels import soft_llr as ks

    tab = constellation.table(Modulation.QPSK)
    y = torch.zeros((2, 500), dtype=torch.complex64, device=dev)
    plan = ks.RowPlan(used=1000, rate="1/2", stride=127)
    for bad in (y.to(torch.complex128), y.reshape(-1), y[:, :100]):
        with pytest.raises(ValueError):
            ks.soft_llr_rows(bad, plan, tab)
    with pytest.raises(ValueError):  # 1000 LLRs a lane: not coprime to 2
        ks.soft_llr_rows(y, plan._replace(stride=2), tab)
    with pytest.raises(ValueError):
        ks.soft_llr_rows(y.real.contiguous(), plan, tab)
    with pytest.raises(ValueError):
        ks.soft_llr_rows(y, plan, tab, torch.ones(2, device=dev))


def test_coded_back_end_runs_two_kernels_on_the_llrs():
    """decode_payload on the card at rate 1/2 (windowed): the rows kernel,
    then the Viterbi kernel, then at most one copy of the decoded bits (the
    windows' interiors); no other kernel and no memset or copy touches the
    LLRs (torch.profiler's kernel list in launch order)."""
    dev = require_cuda()
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from rub_mimo_tpu_torch.ofdm import fec

    cfg = tiny_config(bit_exact=False, pid_max=260)
    y = torch.as_tensor(np.stack(
        [llr_symbols(cfg.modulation, cfg.pid_max * cfg.M_occupied)] * 2),
        device=dev)
    fec.decode_payload(y, cfg)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fec.decode_payload(y, cfg)
        torch.cuda.synchronize()
    names = [e.name for e in sorted(
        (e for e in prof.events() if e.device_type == DeviceType.CUDA),
        key=lambda e: e.time_range.start)]
    assert len(names) in (2, 3), names
    assert "soft_llr_rows_kernel" in names[0], names
    assert "viterbi_kernel" in names[1], names


def test_decode_with_sfo_on_card_matches_cpu():
    """The two-pass SFO flow at 100 ppm on the card: its delta within 1e-6
    of the CPU flow's, the decisions equal, everything on the card."""
    dev = require_cuda()
    from rub_mimo_tpu_torch.estimate import sfo

    cfg = tiny_config(bit_exact=False, pid_max=64,
                      modulation=Modulation.QAM16, sync_fallback=True)
    spec = simulator.ChannelSpec(snr_db=30.0, delay=333, seed=3,
                                 sfo_ppm=100.0)
    cap, txd, _ = simulator.simulate_capture(cfg, spec, device="cpu")
    r_cpu, d_cpu, _ = sfo.decode_with_sfo(cap, cfg, device="cpu")
    r, d, iq = sfo.decode_with_sfo(cap, cfg, device=dev)
    assert {d.device.type, iq.device.type, r.rx_data.device.type} == {dev.type}
    assert abs(float(d) - float(d_cpu)) < 1e-6
    assert torch.equal(r.rx_data.cpu(), r_cpu.rx_data)
    assert abs(float(d) * 1e6 - 100.0) < 15.0


def test_streamed_sfo_on_card_matches_cpu():
    """Three bursts at 100 ppm streamed with sfo_correct on the card and
    on the CPU: the same sfo_hat within 1e-6 and the same decisions."""
    dev = require_cuda()
    cfg = tiny_config(bit_exact=False, pid_max=64,
                      modulation=Modulation.QAM16, track_channel=True,
                      sync_fallback=True)
    spec = simulator.ChannelSpec(snr_db=35.0, delay=0, trailing=0, seed=3,
                                 sfo_ppm=100.0)
    from rub_mimo_tpu_torch.ofdm import framegen

    gap = cfg.window_len + 3 * cfg.symbol_len
    parts = [torch.zeros((2, 300), dtype=torch.complex64)]
    for s in (1, 2, 3):
        t = framegen.transmit_frame(
            cfg, framegen.generate_payload_symbols(cfg, seed=s), device="cpu")
        parts += [t, torch.zeros((2, max(64, gap - t.shape[-1])),
                                 dtype=torch.complex64)]
    parts.append(torch.zeros((2, 500), dtype=torch.complex64))
    h = simulator.draw_channel(spec, 2, 2)
    cap = simulator.apply_channel(torch.cat(parts, dim=-1), h, spec, cfg)
    decs = {}
    for where in ("cpu", dev):
        d = streaming.StreamingDecoder(cfg, device=where, chunk_size=512,
                                       sfo_correct=True)
        C = 512
        x = torch.nn.functional.pad(cap, (0, -(-cap.shape[-1] // C) * C
                                          - cap.shape[-1]))
        for i in range(x.shape[-1] // C):
            d.push(x[:, i * C:(i + 1) * C])
        d.finalize()
        decs[str(where)] = d
    cpu, card = decs["cpu"], decs[str(dev)]
    assert len(card.bursts) == len(cpu.bursts) == 3
    assert abs(card.sfo_hat - cpu.sfo_hat) < 1e-6
    for (si, _, a), (sj, _, b) in zip(card.burst_results(),
                                      cpu.burst_results()):
        assert si == sj and torch.equal(a.cpu(), b)


# ---- the front end, the streamed front end and the command line ----
_FE_CFG = tiny_config(bit_exact=False, pid_max=32, modulation=Modulation.QAM16)
_FE_SPEC = simulator.ChannelSpec(snr_db=35.0, delay=2381, seed=5,
                                 iq_amp_db=1.0, iq_phase_deg=5.0,
                                 dc_offset=0.05 + 0.03j)


def test_frontend_on_card_matches_cpu():
    """estimate_frontend and compensate on the card equal the CPU port's
    within 1e-5 (the reductions sum in another order)."""
    from rub_mimo_tpu_torch.estimate import frontend

    require_cuda()
    cap, _, _ = simulator.simulate_capture(_FE_CFG, _FE_SPEC, device="cpu")
    dc, w = frontend.estimate_frontend(cap)
    gdc, gw = frontend.estimate_frontend(cap.cuda())
    assert gdc.device.type == "cuda"
    np.testing.assert_allclose(n(gdc), n(dc), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(n(gw), n(w), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(n(frontend.compensate(cap.cuda(), gdc, gw)),
                               n(frontend.compensate(cap, dc, w)),
                               rtol=1e-5, atol=1e-5)


def test_streamed_frontend_on_card_matches_cpu():
    """StreamingDecoder(frontend_comp=True) on the card: the decisions of
    the CPU stream (chunks of 256, a push_block after the warm-up), and
    no host read in the payload phase."""
    require_cuda()
    cap, _, _ = simulator.simulate_capture(_FE_CFG, _FE_SPEC, device="cpu")
    C = 256
    nc = -(-cap.shape[-1] // C)
    x = torch.nn.functional.pad(cap, (0, nc * C - cap.shape[-1]))
    outs = []
    for device in ("cpu", "cuda"):
        xd = x.to(device)
        dec = streaming.StreamingDecoder(_FE_CFG, device=device, chunk_size=C,
                                         frontend_comp=True, warmup_chunks=4)
        for i in range(4):
            dec.push(xd[:, i * C:(i + 1) * C])
        dec.push_block(xd[:, 4 * C:8 * C])
        i = 8
        while dec.phase != "payload" and i < nc:
            dec.push(xd[:, i * C:(i + 1) * C])
            i += 1
        reads = dec.host_reads
        while i < nc:
            dec.push(xd[:, i * C:(i + 1) * C])
            if dec.phase == "payload":
                assert dec.host_reads == reads
            i += 1
        dec.finalize()
        assert dec.synced
        outs.append((dec.sync_index, n(dec.result()[1])))
    assert outs[0][0] == outs[1][0]
    np.testing.assert_array_equal(outs[0][1], outs[1][1])


def test_cli_run_on_card(capsys, tmp_path):
    """cli.main(["run", ...]) at tiny dims on the card: SER 0, K1 once a
    decode (two decodes: the first and the timed one), and the checkpoint
    resumes to the same decisions on the card."""
    from rub_mimo_tpu_torch.apps import cli
    from rub_mimo_tpu_torch.pipeline import checkpoint

    require_cuda()
    before = pf.payload_fused_strip.launches
    ck = tmp_path / "run.npz"
    assert cli.main(["run", "--num_subcarriers", "64", "--cp_len", "16",
                     "--num_access_codes", "4", "--frames", "8",
                     "--modulation", "qpsk", "--snr", "35", "--delay", "300",
                     "--save-checkpoint", str(ck)]) == 0
    out = capsys.readouterr().out
    sers = [ln for ln in out.splitlines() if "symbol error rate" in ln]
    assert len(sers) == 2 and all(s.endswith(": 0.000000%") for s in sers)
    assert pf.payload_fused_strip.launches - before == 2
    ckpt = checkpoint.load(ck)
    cap, _, _ = simulator.simulate_capture(
        ckpt.config, simulator.ChannelSpec(snr_db=35.0, delay=300, seed=42),
        payload_seed=42, device="cuda")
    _, data = checkpoint.resume_decode(cap, ckpt, device="cuda")
    assert data.device.type == "cuda"
    np.testing.assert_array_equal(n(data), ckpt.rx_data)


# ---------------------------------------------------------------- K8 across
# processes: two ranks on one card under gloo (the one-card machine runs the
# same IPC path as four cards)
def test_sharded_decode_across_processes_on_one_card(tmp_path):
    """Two gloo ranks of two time shards each on cuda:0, tiny_config's
    (4, 1) and (2, 2) meshes, ``pallas_dma`` and ``ppermute``: each rank
    equal to the single decode with SER 0; under pallas_dma K8 launched
    once a rank a decode, pulling its first shard's halo through the other
    rank's IPC-mapped buffer bit for bit against its plain version."""
    require_cuda()
    from rub_mimo_tpu_torch.parallel import multiprocess as mp

    recs = mp.launch(2, 2, device="cuda:0", backend="gloo",
                     init_method=f"file://{tmp_path}/store",
                     halo_impl=("pallas_dma", "ppermute"), config="tiny",
                     meshes=((4, 1), (2, 2)), timeout=180.0, halo_calls=20)
    assert len(recs) == 8
    for r in recs:
        assert r["equal_to_single"] and r["ser_percent"] == [0.0, 0.0], r
        k8_launches = r["launches"]["ring_shift_right"]
        if r["halo_impl"] == "pallas_dma":
            assert k8_launches == 1 and r["launches"]["sc_metric"] == 1, r
            assert r["k8"]["bit_equal"] and r["k8"]["max_abs_err"] == 0.0
            assert r["k8"]["back_to_back_bit_equal"], r
            assert r["k8"]["host_syncs_per_call"] == 0, r
            assert r["k8"]["launches_per_call"] == 1, r
        else:
            assert k8_launches == 0, r


IPC_ROUND_TRIP = r'''
import ctypes, sys
import torch
import torch.distributed as dist
from rub_mimo_tpu_torch.kernels import halo_dma as k8

rank, store = int(sys.argv[1]), sys.argv[2]
torch.cuda.set_device(0)
dist.init_process_group("gloo", init_method=f"file://{store}", rank=rank,
                        world_size=2)
lib = k8._lib()
S, H = 2, 2047
vals = torch.randn((S, H), dtype=torch.complex64,
                   generator=torch.Generator().manual_seed(3))
info = [None]
if rank == 0:
    big = torch.zeros((5, S, H), dtype=torch.complex64, device="cuda")
    big[3] = vals.cuda()
    torch.cuda.synchronize()
    h, off = ctypes.create_string_buffer(64), ctypes.c_longlong()
    assert lib.ipc_export(0, big[3].data_ptr(), h, ctypes.byref(off)) == 0
    assert off.value >= 3 * S * H * 8  # a view's offset in its block
    info = [(h.raw, off.value)]
dist.broadcast_object_list(info, src=0)
if rank == 1:
    base = ctypes.c_void_p()
    assert lib.ipc_open(0, info[0][0], ctypes.byref(base)) == 0
    out = torch.full((1, S, H), 7.0, dtype=torch.complex64, device="cuda")
    p = k8._Params()
    p.src[0] = base.value + info[0][1]
    p.dst[0] = out[0].data_ptr()
    p.src_row_stride, p.rows, p.len, p.n_dst = H, S, H, 1
    assert lib.ring_shift_right(ctypes.byref(p),
                                torch.cuda.current_stream().cuda_stream) == 0
    torch.cuda.synchronize()
    assert torch.equal(out[0].cpu(), vals)
    assert lib.ipc_close(0, base.value) == 0
dist.barrier()  # the mapping is closed before rank 0 frees the block
dist.destroy_process_group()
print("ok")
'''


def test_ipc_export_open_close_round_trip(tmp_path):
    """csrc/halo_dma.cu's ipc_export / ipc_open / ipc_close between two
    processes on cuda:0: a view into a larger block is exported with its
    offset, mapped by the other process, pulled by K8 bit for bit and
    unmapped before the exporter frees it."""
    require_cuda()
    import os
    import subprocess
    import sys
    from pathlib import Path

    repo = Path(__file__).resolve().parents[1]
    env = dict(os.environ, PYTHONPATH=str(repo))
    procs = [subprocess.Popen(
        [sys.executable, "-c", IPC_ROUND_TRIP, str(r), str(tmp_path / "s")],
        cwd=repo, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True) for r in range(2)]
    try:
        outs = [p.communicate(timeout=120) for p in procs]
    finally:
        for p in procs:
            p.kill()
    for p, (out, err) in zip(procs, outs):
        assert p.returncode == 0, err
        assert out.strip().endswith("ok")


# one rank of K8's cross-process exchange: `calls` back-to-back calls on
# fresh seeded halos written into stage A's rows, with no host sync
# between them (barriers, synchronizes and copies raise meanwhile); rank 0
# (a publisher) queues a sleep before every `sleep_every`-th call
PROCESS_HALO_CALLS = r"""
import sys
import numpy as np
import torch
import torch.distributed as dist
from rub_mimo_tpu_torch.kernels import halo_dma as k8
from rub_mimo_tpu_torch.parallel import mesh as pmesh

rank, world, per, calls, sleep_every = map(int, sys.argv[1:6])
store, backend = sys.argv[6], sys.argv[7]
dev = torch.device("cuda", 0 if backend == "gloo" else rank)
torch.cuda.set_device(dev)
dist.init_process_group(backend, init_method=f"file://{store}", rank=rank,
                        world_size=world)
n_time, S, H, T = world * per, 2, 2047, 3000
mesh = pmesh.make_mesh(n_time, 1, devices=[dev] * per)
mine = [t for t, _ in mesh.local_shards()]
ex = k8.ProcessHalo(mesh, S, H)
rng = np.random.default_rng(7)
cases = []
for _ in range(calls):
    every = (rng.standard_normal((n_time, S, T))
             + 1j * rng.standard_normal((n_time, S, T))).astype(np.complex64)
    tails = [[torch.as_tensor(every[t], device=dev)[:, -H:]
              if t in mine else None] for t in range(n_time)]
    rows = torch.full((len(mine), S, H + T), 7.0, dtype=torch.complex64,
                      device=dev)
    out = [[rows[mine.index(t), :, :H] if t in mine else None]
           for t in range(n_time)]
    want = [np.zeros((S, H), np.complex64) if t == 0 else every[t - 1][:, -H:]
            for t in mine]
    cases.append((tails, rows, out, want))
torch.cuda.synchronize()
dist.barrier()


def refuse(*a, **k):
    raise AssertionError("a host synchronization in the steady state")


saved = [(dist, "barrier"), (torch.cuda.Stream, "synchronize"),
         (torch.cuda, "synchronize"), (torch.Tensor, "copy_")]
saved = [(o, n, getattr(o, n)) for o, n in saved]
for o, n, _ in saved:
    setattr(o, n, refuse)
before = k8.ring_shift_right.launches
try:
    for i, (tails, _, out, _) in enumerate(cases):
        if sleep_every and rank == 0 and i % sleep_every == 0:
            torch.cuda._sleep(20_000_000)
        assert ex(tails, out=out) is out
finally:
    for o, n, fn in saved:
        setattr(o, n, fn)
assert k8.ring_shift_right.launches - before == calls
assert ex.epoch == calls
torch.cuda.synchronize()
for c, (_, rows, _, want) in enumerate(cases):
    got = rows.cpu().numpy()
    for i, t in enumerate(mine):
        assert np.array_equal(got[i, :, :H], want[i]), (c, t)
        assert (got[i, :, H:] == 7).all(), (c, t)
ex.close()
dist.destroy_process_group()
print("ok", calls)
"""


def _run_ranks(script: str, argvs: list, timeout: float = 240.0) -> list:
    """Run ``script`` once per argv, as processes of this checkout; their
    (return code, stdout, stderr), every process ended."""
    import os
    import subprocess
    import sys
    from pathlib import Path

    repo = Path(__file__).resolve().parents[1]
    env = dict(os.environ, PYTHONPATH=str(repo))
    procs = [subprocess.Popen(
        [sys.executable, "-c", script, *map(str, argv)], cwd=repo, env=env,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for argv in argvs]
    try:
        outs = [p.communicate(timeout=timeout) for p in procs]
    finally:
        for p in procs:
            p.kill()
            p.wait()
    return [(p.returncode, o, e) for p, (o, e) in zip(procs, outs)]


@pytest.mark.parametrize("sleep_every", [0, 50], ids=["steady",
                                                     "late_publisher"])
def test_process_halo_back_to_back_on_one_card(tmp_path, sleep_every):
    """Two gloo ranks of two shards on cuda:0: 200 back-to-back exchanges
    with no host sync between them, each halo bit for bit in stage A's
    rows; with a late publisher (a sleep queued before its launch) the
    reader still gets that call's halo."""
    require_cuda()
    res = _run_ranks(PROCESS_HALO_CALLS, [
        (r, 2, 2, 200, sleep_every, tmp_path / "store", "gloo")
        for r in range(2)])
    for rc, out, err in res:
        assert rc == 0, err[-3000:]
        assert out.strip().endswith("ok 200")


@pytest.mark.parametrize("sleep_every", [0, 50], ids=["steady",
                                                     "late_publisher"])
def test_process_halo_back_to_back_across_cards(tmp_path, sleep_every):
    """One NCCL rank a card (every card present, one shard each): 200
    back-to-back exchanges, each halo pulled over NVLink bit for bit."""
    devs = require_cuda_devices(2)
    res = _run_ranks(PROCESS_HALO_CALLS, [
        (r, len(devs), 1, 200, sleep_every, tmp_path / "store", "nccl")
        for r in range(len(devs))])
    for rc, out, err in res:
        assert rc == 0, err[-3000:]
        assert out.strip().endswith("ok 200")


# the reader rank of two on cuda:0 calls with a 0.5 s limit while its
# publisher never calls: its next synchronize raises, and so do its later
# calls
PROCESS_HALO_TIMEOUT = r"""
import os, sys, time
import torch
import torch.distributed as dist
from rub_mimo_tpu_torch.kernels import halo_dma as k8
from rub_mimo_tpu_torch.parallel import mesh as pmesh

rank, store = int(sys.argv[1]), sys.argv[2]
dev = torch.device("cuda", 0)
torch.cuda.set_device(dev)
dist.init_process_group("gloo", init_method=f"file://{store}", rank=rank,
                        world_size=2)
mesh = pmesh.make_mesh(4, 1, devices=[dev] * 2)
S, H = 2, 2047
ex = k8.ProcessHalo(mesh, S, H, timeout_s=0.5)
if rank == 1:
    x = torch.ones((S, H), dtype=torch.complex64, device=dev)
    parts = [[None], [None], [x], [x]]
    out = [[None], [None], [torch.empty_like(x)], [torch.empty_like(x)]]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ex(parts, out=out)
    try:
        torch.cuda.synchronize()
        print("no error", flush=True)
    except RuntimeError as e:
        print("raised after", time.perf_counter() - t0, flush=True)
        for _ in range(2):
            try:
                ex(parts, out=out)
                print("call returned", flush=True)
            except RuntimeError:
                print("call raised", flush=True)
dist.barrier()
print("done", flush=True)
os._exit(0)
"""


def test_process_halo_late_past_the_limit_raises(tmp_path):
    """A peer that never calls: the reader's kernel traps once its wait
    passes the 0.5 s limit, its next synchronize raises well within the
    test's own limit (no hang), and every later call raises (the epochs
    are apart).  Each rank is its own process: the trap ends the
    reader's context."""
    require_cuda()
    res = _run_ranks(PROCESS_HALO_TIMEOUT,
                     [(r, tmp_path / "store") for r in range(2)],
                     timeout=120.0)
    for rc, out, err in res:
        assert rc == 0, err[-3000:]
        assert out.strip().endswith("done")
    lines = res[1][1].splitlines()
    raised = [ln for ln in lines if ln.startswith("raised after")]
    assert raised, res[1][1]
    assert 0.5 <= float(raised[0].split()[-1]) < 30.0
    assert [ln for ln in lines if ln.startswith("call ")] == [
        "call raised"] * 2
