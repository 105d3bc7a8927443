"""Sharded decode of one capture over a ("time", "sc") mesh (port of
rub_mimo_tpu/parallel/decode_sharded.py).

The capture's time axis is cut into n_time blocks (parallel.mesh); one
controller runs each stage body over the shards, with the exchanges and
reductions of parallel.collectives where the JAX package had shard_map's
lax collectives:

  stage A — S&C sync per time block.  The default coarse+refine stage
    (``_coarse_sync_stage``: exact metric at D-aligned points from block
    sums over [left halo | block], the boundary pair, K = 4 candidate
    refinements, the tail guard on the last shard, the run starts left
    of the fire) falls back to the full-rate stage (``_sync_stage``)
    when its exactness flag is raised.  The full-rate stage takes its
    (M-1)-sample left halo from K8 (kernels.halo_dma, ``halo_impl=
    "pallas_dma"``; one launch per card, pulling across cards by peer
    access, writing into the rows K6 reads) or from the ppermute
    collective, the metric of every shard's
    [halo | block] from K6 in one launch per card (rows stacked), the
    cross-shard run-start carry from an all_gather prefix max, and
    elects the first fire with pmin / psum.  With sync_fallback, the S0
    cross-correlation (``_xcorr_stage``) elects its best peak likewise.
  stage B — the estimation region: each time shard's overlap with it,
    psum over "time"; the matched filter's templates (``_mf_stage``) and
    the LS code FFTs (``_estimate_stage``) are split over "sc" and
    gathered.
  stage C — the payload (``_payload_stage``): each shard strips, FFTs and
    equalizes the symbols whose first sample lies in its block, every
    n_sc-th one from its "sc" rank, reading up to one symbol into the
    right neighbour's block (ppermute).  On CUDA meshes, where the JAX
    package runs its fused TPU kernel (all subcarriers occupied, RX_ZF,
    ZF or MMSE, no tracking), each shard runs K1 on its span with the
    symbol pitch n_sc * symbol_len; elsewhere the strip is K7,
    ``torch.fft``, and the per-symbol detector with its postprocess; the
    Alamouti and channel-tracking tails run on the assembled grid.  The
    final demap is constellation.demodulate (K4 on CUDA).  Each symbol
    has one owner, so the JAX package's psum assembly is a placement of
    each owner's rows here.

Each stage body runs once for each distinct value it makes: the sync
stages and the region parts on the shards of "sc" column 0 (their
results are replicated over "sc"), the matched filter and the LS code
FFTs on "time" row 0 (replicated over "time"), the CFO de-rotation and
the payload on every shard.  Replicated results (sync, region, channel,
weights) are kept on the mesh's home device, shard (0, 0)'s, where the
decode returns them.

On a mesh over several processes (parallel.mesh.init_distributed) each
rank runs the stage bodies of its own shards and the collectives move
values between ranks.  The time stages run on "sc" column 0 as above;
the sc stages on a time row this rank holds (each rank holds whole
rows), so the region, the matched filter, the LS estimate and the
weights come out replicated on every rank; K8's halo crosses ranks
through kernels.halo_dma.ProcessHalo (``pallas_dma``: one launch a rank
publishes, waits on the neighbour rank's flag word and pulls, all on the
device, with no host barrier or synchronize).  Stage C's rows
are summed over the ranks (one owner each), so every rank returns the
whole ShardedDecodeResult on its first shard's device.  The decoder's
``close()`` (every rank at once) releases what ProcessHalo mapped.  A
decode that raises on a rank leaves the exchange's epochs apart: its
later decodes raise, and the decoder is closed and rebuilt on every
rank.

Host reads (each drains the stream on a GPU), as the JAX package's
conds: the coarse stage's exactness flag (``need_full``; coarse stage A
only), the region start (sync_index) and the payload start
(decode_start), each read once.  Every ``lax.cond`` / ``lax.switch``
of the JAX stages on a replicated flag or start becomes a Python branch
on these host values.  Integers are int64 (the JAX stages' int32, with
the same 2**30 sentinel).  Outputs are in natural subcarrier order, with
no ``payload_perm`` (a TPU layout).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F

from rub_mimo_tpu_torch.config import CommMode, Detector, ModemConfig, \
    check_config
from rub_mimo_tpu_torch.detect import alamouti, dispatch, postprocess, \
    tracking
from rub_mimo_tpu_torch.detect import weights as weights_mod
from rub_mimo_tpu_torch.estimate import cfo as cfo_mod
from rub_mimo_tpu_torch.estimate import ls, smooth
from rub_mimo_tpu_torch.kernels import cp_strip as cp_strip_mod
from rub_mimo_tpu_torch.kernels import halo_dma
from rub_mimo_tpu_torch.kernels import payload_fused
from rub_mimo_tpu_torch.kernels import sc_metric as k6
from rub_mimo_tpu_torch.kernels.sc_sync import cummax
from rub_mimo_tpu_torch.ofdm import constellation
from rub_mimo_tpu_torch.parallel import collectives as coll
from rub_mimo_tpu_torch.parallel.mesh import Mesh
from rub_mimo_tpu_torch.pipeline import rx
from rub_mimo_tpu_torch.sync import matched_filter, schmidl_cox, xcorr_sync

BIG = 2 ** 30
K_CAND = 4  # candidate pairs the coarse stage refines per shard
HALO_IMPLS = ("ppermute", "pallas_dma")


class ShardedDecodeResult(NamedTuple):
    synced: torch.Tensor       # bool
    sync_index: torch.Tensor   # int64
    sync_sample: torch.Tensor  # int64
    cfo_hat: torch.Tensor      # float32, subcarrier units (total)
    G: torch.Tensor            # complex64 [M, rx, tx]
    decode_start: torch.Tensor  # int64
    rx_sig: torch.Tensor       # complex64 [S, pid_max * M_occ]
    rx_data: torch.Tensor      # int32 [S, pid_max * M_occ]


def _column(mesh: Mesh) -> Mesh:
    """The "sc" column 0 of the mesh: the shards of the time stages."""
    return mesh.sub(cols=slice(0, 1))


def _row(mesh: Mesh) -> Mesh:
    """The first "time" row this process holds (row 0 on one process):
    the shards of the sc stages."""
    t = mesh.local_shards()[0][0]
    return mesh.sub(rows=slice(t, t + 1))


def _home(parts, mesh: Mesh):
    """This process's copy of a replicated per-shard value (its first
    shard's)."""
    t, s = mesh.local_shards()[0]
    return parts[t][s]


def _per_block(mesh: Mesh, key, fn):
    """fn(t, s) on every shard, once per distinct key(t, s): the shards
    of a time row that hold the same block tensor share the result."""
    done = {}

    def one(t, s):
        k = key(t, s)
        if k not in done:
            done[k] = fn(t, s)
        return done[k]

    return coll.for_each(mesh, one)


# --------------------------------------------------------------- stage A
def stage_a_rows(blocks, mesh: Mesh, H: int, halo_impl: str,
                 exchange=None) -> dict:
    """Stage A's K6 input: per device, (the time shards ts it holds,
    [len(ts), S, H + Tloc] complex64), shard t's rows its left halo (the
    last H samples of shard t - 1, zeros for t = 0) then blocks[t][0].
    K8 (``pallas_dma``) writes the halo columns itself (``out=``);
    ``exchange``: the halo_dma.ProcessHalo of a mesh over several ranks."""
    n_time = mesh.shape["time"]
    mine = [t for t, _ in mesh.local_shards()]
    S, Tloc = blocks[mine[0]][0].shape
    by_dev = {}
    for t in mine:
        by_dev.setdefault(blocks[t][0].device, []).append(t)
    rows, left = {}, [[None] for _ in range(n_time)]
    for dev, ts in by_dev.items():
        buf = torch.empty((len(ts), S, H + Tloc), dtype=torch.complex64,
                          device=dev)
        for i, t in enumerate(ts):
            buf[i, :, H:] = blocks[t][0]
            left[t][0] = buf[i, :, :H]
        rows[dev] = (ts, buf)
    tails = coll.for_each(mesh, lambda t, s: blocks[t][s][:, -H:])
    if exchange is not None:
        exchange(tails, out=left)
    elif n_time > 1 and halo_impl == "pallas_dma":
        halo_dma.ring_shift_right(tails, mesh, out=left)
    else:
        got = coll.ppermute_right(tails, mesh)  # zeros when n_time == 1
        for t in mine:
            left[t][0].copy_(got[t][0])
    return rows


def _sync_stage(blocks, mesh: Mesh, cfg: ModemConfig, halo_impl: str,
                exchange=None):
    """Full-rate per-shard sync over blocks[t][0] [S, Tloc]: (t*, run
    starts [S], fired, corr at t* [S], participating streams [S]),
    replicated (decode_sharded.py:87-161 of the JAX package)."""
    n_time = mesh.shape["time"]
    t0 = mesh.local_shards()[0][0]
    S, Tloc = blocks[t0][0].shape
    H = cfg.M - 1

    # the metric of every shard's [left | local] from K6, the shards of
    # one device stacked as rows of one launch (rows are independent)
    L = H + Tloc
    ext, metric = {}, {}
    for ts, buf in stage_a_rows(blocks, mesh, H, halo_impl,
                                exchange).values():
        m = k6.sc_metric_fused(buf.reshape(-1, L), cfg.M,
                               block=min(1 << 15, L)).reshape(len(ts), S, L)
        for i, t in enumerate(ts):
            ext[t], metric[t] = buf[i], m[i, :, H:]

    thr, cp = cfg.plateau_threshold, cfg.cp_len
    q = S if cfg.sync_quorum is None else cfg.sync_quorum

    def scan(t, s):
        m = metric[t]
        gidx = t * Tloc + torch.arange(Tloc, device=m.device)
        above = m > thr
        cm = cummax(torch.where(above, -1, gidx))
        return above, gidx, cm

    scans = coll.for_each(mesh, scan)
    all_max = coll.all_gather(
        coll.for_each(mesh, lambda t, s: scans[t][s][2][:, -1]), mesh)

    def fire(t, s):
        above, gidx, cm = scans[t][s]
        dev = gidx.device
        prev = torch.arange(n_time, device=dev)[:, None] < t
        prefix = torch.where(prev, all_max[t][s], -1).max(dim=0).values
        run_start = torch.maximum(cm, prefix[:, None]) + 1
        cond = above & ((gidx - run_start) > cp)
        cond_all = cond.sum(dim=0) >= q
        fired = cond_all.any()
        t_loc = torch.argmax(cond_all.to(torch.uint8))
        t_global = torch.where(fired, gidx[t_loc], BIG)
        starts = run_start[:, t_loc]
        pmask = torch.ones((S,), dtype=torch.bool, device=dev)
        if q < S:
            pmask = torch.where(fired, cond[:, t_loc], pmask)
        c_at = schmidl_cox.corr_at(ext[t], t_loc + H, cfg.M)
        return fired, t_global, starts, pmask, torch.where(pmask, c_at, 0)

    f = coll.for_each(mesh, fire)

    def field(i):
        return coll.for_each(mesh, lambda t, s: f[t][s][i])

    fired, t_global = field(0), field(1)
    best_t = coll.pmin(t_global, mesh)
    fired_any = coll.pmax(coll.for_each(
        mesh, lambda t, s: fired[t][s].to(torch.int64)), mesh)
    win = coll.for_each(mesh, lambda t, s: fired[t][s]
                        & (t_global[t][s] == best_t[t][s]))

    def elect(i, dtype):
        return _home(coll.psum(coll.for_each(
            mesh, lambda t, s: torch.where(win[t][s], f[t][s][i].to(dtype),
                                           0)), mesh), mesh)

    fired_any = _home(fired_any, mesh) > 0
    starts = elect(2, torch.int64)
    pmask = torch.where(fired_any, elect(3, torch.int64) > 0, True)
    corr = elect(4, torch.complex64)
    return _home(best_t, mesh), starts, fired_any, corr, pmask


def coarse_left_halo(cfg: ModemConfig) -> int:
    """D-aligned left halo of ``_coarse_sync_stage``: the coarse block
    sums, the candidate refinement and the run-start scan left of any
    fire the shard owns.  The coarse stage needs Tloc >= this."""
    D = schmidl_cox._coarse_stride(cfg)
    return -(-(3 * cfg.M + 2 * cfg.cp_len + 2 * D) // D) * D


def _ext_windows(left, local, right, starts, L: int):
    """[K, S, L] windows of the conceptual [left | local | right] at the
    ext coordinates ``starts`` [K] (each in [0, len - L]), gathered from
    the three parts without forming the shard-sized concatenation."""
    H, Tloc, R = left.shape[1], local.shape[1], right.shape[1]
    idx = starts.reshape(-1, 1) + torch.arange(L, device=local.device)
    w = torch.where(
        idx < H, left[:, idx.clamp(max=H - 1)],
        torch.where(idx < H + Tloc, local[:, (idx - H).clamp(0, Tloc - 1)],
                    right[:, (idx - H - Tloc).clamp(0, R - 1)]))
    return w.transpose(0, 1)


def _mov(bs: torch.Tensor, k: int) -> torch.Tensor:
    cs = torch.cumsum(bs, dim=-1)
    return cs - F.pad(cs[:, :-k], (k, 0))


def _run_fire(above: torch.Tensor, cp: int) -> torch.Tensor:
    """above [..., L] (all streams) -> held for the cp+2 samples ending
    at each position."""
    rl = torch.cumsum(above.to(torch.int64), dim=-1)
    rl = rl - F.pad(rl[..., : -(cp + 2)], (cp + 2, 0))
    return rl >= cp + 2


def _coarse_local(local, left, right, t: int, cfg: ModemConfig,
                  n_time: int, T_total: int):
    """One shard's coarse+refine scan (decode_sharded.py:174-399 of the
    JAX package), in ext coordinates i <-> global shard0 - halo + i of
    [left | local | right].  Returns (t_best, starts [S], corr at
    t_best [S], run_saturated, candidate count)."""
    S, Tloc = local.shape
    dev = local.device
    M, cp, thr = cfg.M, cfg.cp_len, cfg.plateau_threshold
    M2 = M // 2
    D = schmidl_cox._coarse_stride(cfg)
    K = K_CAND
    shard0 = t * Tloc
    halo = left.shape[1]
    Te = halo + Tloc
    Ter = Te + right.shape[1]
    Lp = 2 * cp + 2
    Lw = (M - 1) + Lp
    run_w = 2 * M + 2 * cp
    Lr = (M - 1) + run_w
    big = T_total + 10 * M

    # ---- coarse pass: block sums over [left | local[:M2]] and local
    # itself (the blocks past halo + M2 read only local samples) ----
    kM2, b0, nloc = M2 // D, halo // D, Tloc // D
    bs1_p, bs1_e = schmidl_cox.coarse_block_sums(
        torch.cat([left, local[:, :M2]], dim=-1), M2, b0 + kM2, D)
    bsl_p, bsl_e = schmidl_cox.coarse_block_sums(local, M2, nloc, D)
    corr_c = -_mov(torch.cat([bs1_p, bsl_p[:, kM2:]], dim=-1), M2 // D)
    e_c = 0.5 * _mov(torch.cat([bs1_e, bsl_e[:, kM2:]], dim=-1), M // D)
    metric_c = (corr_c.real ** 2 + corr_c.imag ** 2) / (e_c * e_c)
    # coarse point i sits at ext position i*D + D - 1; the local points
    # start at block b0, block b0 - 1 is the neighbour's last point (the
    # j = -1 boundary pair), which shard 0 does not have
    all_c = (metric_c > thr).all(dim=0)
    loc_above = all_c[b0 - 1: b0 + nloc].clone()
    if t == 0:
        loc_above[0] = False
    pair = loc_above[:-1] & loc_above[1:]
    n_cand = pair.sum()
    jidx = torch.arange(nloc, device=dev)
    cand_j = -torch.topk(torch.where(pair, -jidx, -big), K).values  # ascending

    # ---- refine the K candidates with exact-metric windows ----
    t_e = halo + cand_j * D + D - 1
    p0 = t_e - cp - 1
    cl = torch.clamp(p0 - (M - 1), 0, Ter - Lw)
    m_w, _ = schmidl_cox._metric_from_slice(
        _ext_windows(left, local, right, cl, Lw), M)          # [K, S, Lw]
    qs = torch.clamp((p0 - cl).unsqueeze(1)
                     + torch.arange(Lp, device=dev), 0, Lw - 1)  # [K, Lp]
    pos = cl.unsqueeze(1) + qs
    gpos = shard0 - halo + pos
    above = (torch.gather(m_w, 2, qs.unsqueeze(1).expand(K, S, Lp))
             > thr).all(dim=1)
    fire = (_run_fire(above, cp) & (pos >= t_e.unsqueeze(1)) & (gpos >= 0)
            & (gpos < T_total))
    p_fire = torch.where(fire, gpos, big).min(dim=1).values
    ok = (cand_j < nloc) & (shard0 + cand_j * D + D - 1 + cp < T_total)
    t_best = torch.where(ok, p_fire, big).min()

    # ---- tail guard (last shard): a burst in the final ~2D samples whose
    # coarse pair falls past the aligned grid ----
    if t == n_time - 1:
        Wt = 2 * cp + 4 * D + 2
        tail_len = (M - 1) + Wt + cp + 2
        m_t, _ = schmidl_cox._metric_from_slice(local[:, Tloc - tail_len:], M)
        qs_t = (M - 1) + torch.arange(Wt + cp + 2, device=dev)
        gpos_t = shard0 - halo + (Te - tail_len) + qs_t
        fire_t = (_run_fire((m_t[:, qs_t] > thr).all(dim=0), cp)
                  & (gpos_t >= T_total - 2 * D - cp) & (gpos_t < T_total))
        t_best = torch.minimum(
            t_best, torch.where(fire_t, gpos_t, big).min())
    synced = t_best < big

    # ---- run starts and corr at t_best: exact scan of the run_w samples
    # that end there (the left halo covers it for any fire owned here) ----
    r_cl_g = torch.clamp(t_best - run_w + 1 - (M - 1), 0, max(T_total - Lr, 0))
    r_cl_e = torch.clamp(r_cl_g - shard0 + halo, 0, Ter - Lr)
    m_r, corr_r = schmidl_cox._metric_from_slice(
        _ext_windows(left, local, right, r_cl_e.reshape(1), Lr)[0], M)
    gpos_r = shard0 - halo + r_cl_e + torch.arange(Lr, device=dev)
    in_scan = (gpos_r <= t_best) & (gpos_r > t_best - run_w)
    below = ~(m_r > thr) & in_scan.unsqueeze(0)
    last_below = torch.where(below, gpos_r.unsqueeze(0), -1).max(dim=1).values
    run_saturated = (synced & (t_best - run_w + 1 > 0)
                     & (last_below == -1).any())
    at = t_best - (shard0 - halo + r_cl_e)
    hit = (at >= 0) & (at < Lr)
    c_at = torch.where(hit, corr_r[:, at.clamp(0, Lr - 1)], 0)
    return t_best, last_below + 1, c_at, run_saturated, n_cand


def _coarse_sync_stage(blocks, mesh: Mesh, cfg: ModemConfig, T_total: int):
    """Coarse+refine sync over blocks[t][0]: (need_full, (t*, starts,
    fired, corr at t*, participating streams)), replicated; the caller
    runs ``_sync_stage`` when need_full (JAX: the lax.cond at
    decode_sharded.py:878)."""
    n_time = mesh.shape["time"]
    S = cfg.num_streams
    big = T_total + 10 * cfg.M
    halo = coarse_left_halo(cfg)
    left = coll.ppermute_right(coll.for_each(
        mesh, lambda t, s: blocks[t][s][:, -halo:]), mesh)
    right = coll.ppermute_left(coll.for_each(
        mesh, lambda t, s: blocks[t][s][:, :cfg.cp_len + 2]), mesh)
    r = coll.for_each(mesh, lambda t, s: _coarse_local(
        blocks[t][s], left[t][s], right[t][s], t, cfg, n_time, T_total))
    best_t = coll.pmin(coll.for_each(mesh, lambda t, s: r[t][s][0]), mesh)
    win = coll.for_each(mesh, lambda t, s: (r[t][s][0] < big)
                        & (r[t][s][0] == best_t[t][s]))

    def elect(i):
        return _home(coll.psum(coll.for_each(
            mesh, lambda t, s: torch.where(win[t][s], r[t][s][i], 0)), mesh),
            mesh)

    need = coll.pmax(coll.for_each(mesh, lambda t, s: (
        (r[t][s][3] & win[t][s])
        | ((r[t][s][0] >= big) & (r[t][s][4] > K_CAND))).to(torch.int64)),
        mesh)
    best_t = _home(best_t, mesh)
    fired = best_t < big
    starts = torch.where(fired, elect(1), 1)
    corr = torch.where(fired, elect(2), 0)
    best_t = torch.where(fired, best_t, BIG)
    ones = torch.ones((S,), dtype=torch.bool, device=best_t.device)
    return _home(need, mesh) > 0, (best_t, starts, fired, corr, ones)


# --------------------------------------------------- S0 xcorr fallback
def _xcorr_stage(blocks, mesh: Mesh, cfg: ModemConfig, T_total: int):
    """The normalized S0 matched filter per time shard (its block and M
    samples of the right neighbour's), the best peak elected with
    pmax / pmin: (score, global index), replicated."""
    M = cfg.M
    right = coll.ppermute_left(coll.for_each(
        mesh, lambda t, s: blocks[t][s][:, :M]), mesh)

    def local(t, s):
        x = blocks[t][s]
        Tloc = x.shape[1]
        score = xcorr_sync.normalized_s0_score(
            torch.cat([x, right[t][s]], dim=-1), cfg, Tloc)
        gidx = t * Tloc + torch.arange(Tloc, device=x.device)
        score = torch.where(gidx < T_total - M, score, 0.0)
        return score.max(), gidx[torch.argmax(score)]

    r = coll.for_each(mesh, local)
    best = coll.pmax(coll.for_each(mesh, lambda t, s: r[t][s][0]), mesh)
    idx = coll.pmin(coll.for_each(mesh, lambda t, s: torch.where(
        r[t][s][0] == best[t][s], r[t][s][1], BIG)), mesh)
    return _home(best, mesh), _home(idx, mesh)


# ------------------------------------------------------- CFO derotation
def _derotate_stage(local: torch.Tensor, t: int, eps: torch.Tensor,
                    ref: float, M: int) -> torch.Tensor:
    """out[g] = x[g] exp(-2j pi eps (g - ref) / M) at global positions g,
    counted in float32."""
    Tloc = local.shape[1]
    g = (t * Tloc + torch.arange(Tloc, device=local.device)).to(torch.float32)
    rot = torch.exp(-2j * np.pi * eps.to(local.device) * (g - ref) / M)
    return (local * rot).to(torch.complex64)


# --------------------------------------------------------------- stage B
def _region_stage(local: torch.Tensor, t: int, rstart: int,
                  region_len: int) -> torch.Tensor:
    """This time shard's part of capture[rstart : rstart + region_len]:
    its overlap in place, zeros elsewhere (outside the capture too)."""
    S, Tloc = local.shape
    part = torch.zeros((S, region_len), dtype=local.dtype, device=local.device)
    lo, hi = max(rstart, t * Tloc), min(rstart + region_len, (t + 1) * Tloc)
    if lo < hi:
        part[:, lo - rstart:hi - rstart] = local[:, lo - t * Tloc:
                                                 hi - t * Tloc]
    return part


def _chunk(n: int, parts: int):
    """(chunk, padded): the smallest equal split of n over parts."""
    chunk = -(-n // parts)
    return chunk, chunk * parts


def _mf_stage(region: torch.Tensor, row: Mesh, cfg: ModemConfig, joint: bool):
    """The matched filter with its templates split over "sc": each rank
    correlates its chunk, the chunks are gathered, then the argmax.
    Returns (s0_index [S], ac_index [S, codes*S]) on the home device."""
    S, sym = cfg.num_streams, cfg.symbol_len
    n_seq = 1 + cfg.num_access_codes * S
    chunk, _ = _chunk(n_seq, row.shape["sc"])

    def one(t, s):
        dev = row.devices[t, s]
        tf, base = matched_filter.template_chunk(cfg, s * chunk, chunk, dev)
        return matched_filter.corr_vals(region.to(dev), cfg, tf, base)

    g = _home(coll.all_gather(coll.for_each(row, one), row, "sc"), row)
    vals = g.transpose(0, 1).reshape(S, -1, sym)[:, :n_seq]
    mf = matched_filter.finalize(vals, cfg, joint=joint)
    return mf.s0_index, mf.ac_index


def _estimate_stage(region: torch.Tensor, ac_index: torch.Tensor, row: Mesh,
                    cfg: ModemConfig, need_nv: bool):
    """LS estimate with the access codes' FFTs split over "sc" and
    gathered: (G [M, rx, tx], noise variance) on the home device."""
    S, M, codes = cfg.num_streams, cfg.M, cfg.num_access_codes
    chunk, codes_pad = _chunk(codes, row.shape["sc"])
    off = F.pad(ls.ac_offsets(ac_index, cfg),
                (0, 0, 0, 0, 0, codes_pad - codes))

    def one(t, s):
        dev = row.devices[t, s]
        return ls.code_ffts(region.to(dev),
                            off[s * chunk:(s + 1) * chunk].to(dev), cfg)

    X = _home(coll.all_gather(coll.for_each(row, one), row, "sc"), row)
    X = X.reshape(codes_pad, S, S, M)[:codes]
    G = ls.channel_from_ffts(X, cfg)
    nv = (ls.noise_var_from_ffts(X, G, cfg) if need_nv
          else cfg.mmse_noise_var)
    return G, nv


# --------------------------------------------------------------- stage C
def _span(local, right, off: int, L: int, out: torch.Tensor) -> torch.Tensor:
    """out[:, :] = [local | right][:, off : off + L], zeros past the end
    (off >= 0)."""
    Tloc, R = local.shape[1], right.shape[1]
    out.zero_()
    a, b = min(off, Tloc), min(off + L, Tloc)
    if a < b:
        out[:, a - off:b - off] = local[:, a:b]
    c, d = min(max(off, Tloc), Tloc + R), min(off + L, Tloc + R)
    if c < d:
        out[:, c - off:d - off] = right[:, c - Tloc:d - Tloc]
    return out


def _payload_stage(local, right, t: int, s: int, pstart: int,
                   cfg: ModemConfig, n_sc: int, W, gain, G_occ, fused: bool):
    """The payload symbols that start in this shard's block, every n_sc-th
    from slot s (decode_sharded.py:528-707 of the JAX package).  Returns
    (first global symbol k, owned count n, sig, data): the owned symbols
    are k, k + n_sc, ..., k + (n-1) n_sc; with ``fused`` (K1) sig and
    data are [S, n, M] equalized symbols and decisions, else data is None
    and sig the [n, S, m_occ] grid rows (equalized and postprocessed when
    the detector is per-symbol)."""
    S, Tloc = local.shape
    sym, M, cp = cfg.symbol_len, cfg.M, cfg.cp_len
    nloc = -(-Tloc // sym) + 1  # symbol slots a shard can own
    nloc_sc = -(-nloc // n_sc)
    base = t * Tloc
    k0 = max(0, -((pstart - base) // sym))  # first symbol at or past base
    rel0 = pstart + k0 * sym - base
    js = s + np.arange(nloc_sc) * n_sc
    n_own = int(((rel0 + js * sym < Tloc) & (k0 + js < cfg.pid_max)).sum())
    stride = n_sc * sym
    L = nloc_sc * stride
    off = rel0 + s * sym
    if fused:
        planes = torch.empty((2, S, L), dtype=torch.float32,
                             device=local.device)
        _span(local.real, right.real, off, L, planes[0])
        _span(local.imag, right.imag, off, L, planes[1])
        sig, dat = payload_fused.payload_fused_strip(
            planes[0], planes[1], W, gain,
            constellation.table(cfg.modulation),
            np.float32(1.0 / np.sqrt(cfg.M_occupied)), n_sym=nloc_sc,
            symbol_len=stride, cp_len=cp, M=M)
        return k0 + s, n_own, sig[:, :n_own], dat[:, :n_own]
    if n_own == 0:
        return k0 + s, 0, None, None
    span = _span(local, right, off, L, torch.empty(
        (S, L), dtype=torch.complex64, device=local.device))
    x_t = cp_strip_mod.cp_strip(span, nloc_sc, stride, cp)[:, :n_own, :M]
    X = torch.fft.fft(x_t, dim=-1) * float(
        np.float32(1.0 / np.sqrt(cfg.M_occupied)))
    if not rx._occupied(cfg)[0]:
        X = X[:, :, rx._occupied_on(cfg, X.device)]
    Y = X.transpose(0, 1)  # [n, S(rx), m_occ]
    if cfg.mode != CommMode.ALAMOUTI and not cfg.track_channel:
        Y = postprocess.postprocess_eq(
            dispatch.equalize_dispatch(Y, G_occ, W, gain, cfg), cfg)
    return k0 + s, n_own, Y, None


def build_sharded_decoder(cfg: ModemConfig, mesh: Mesh, T: int,
                          halo_impl: str = "ppermute",
                          input_format: str = "complex"):
    """A decoder of captures of T samples sharded over ``mesh`` with
    parallel.mesh.shard_capture (T a multiple of the "time" size).

    halo_impl: "ppermute" (the collective; the coarse stage A where it
    applies) or "pallas_dma" (K8 for the full-rate stage A's halo, which
    it then always takes, as in the JAX package; every shard on one
    device, or every shard on CUDA devices: one launch per card, reading
    across cards by peer access; on a mesh over several ranks, each
    rank's shards on one CUDA device, one launch a rank through
    halo_dma.ProcessHalo).  input_format: "complex" takes the
    blocks of shard_capture, "planes" the (re, im) blocks of
    shard_capture_planes.  Returns
    ``fn(blocks)`` or ``fn(re_blocks, im_blocks)`` -> ShardedDecodeResult
    on the mesh's home device; ``fn.close()`` releases the cross-process
    halo's mappings (every rank at once)."""
    check_config(cfg, "build_sharded_decoder")
    S, M, sym = cfg.num_streams, cfg.M, cfg.symbol_len
    n_time, n_sc = mesh.shape["time"], mesh.shape["sc"]
    if T % n_time:
        raise ValueError("T must be padded to a multiple of the time axis")
    if T // n_time < sym:
        raise ValueError("each time shard must cover at least symbol_len")
    if halo_impl not in HALO_IMPLS:
        raise ValueError(f"unknown halo_impl {halo_impl!r}")
    if input_format not in ("complex", "planes"):
        raise ValueError(f"unknown input_format {input_format!r}")
    devices = set(mesh.devices.flat)
    on_cuda = all(d.type == "cuda" for d in devices)
    # shards held by different ranks are never on one device
    places = {(mesh.rank_of(t, s), mesh.devices[t, s])
              for t in range(n_time) for s in range(n_sc)}
    if (halo_impl == "pallas_dma" and n_time > 1 and len(places) > 1
            and not on_cuda):
        where = sorted(f"rank {r} {d}" if mesh.spans_processes else str(d)
                       for r, d in places)
        raise ValueError("halo_impl='pallas_dma' needs every shard on one "
                         "device or every shard on CUDA devices (K8 pulls "
                         "a neighbour's halo from its card by peer access "
                         f"or by IPC handle); the mesh spans {where}")
    if on_cuda:  # full float32 products, as make_decoder sets them
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    n_seq = 1 + cfg.num_access_codes * S
    region_len = sym * n_seq + M
    joint = (not cfg.bit_exact) and cfg.timing_mode == "joint"
    need_nv = cfg.detector == Detector.MMSE and cfg.mmse_auto_noise
    all_occ = rx._occupied(cfg)[0]
    fused = on_cuda and rx.kernel_applicable(cfg, "fused_strip")
    m_occ = cfg.M_occupied
    Tloc = T // n_time
    D = schmidl_cox._coarse_stride(cfg)
    coarse_ok = (
        D >= 2 and (M // 2) % D == 0 and Tloc % D == 0
        and Tloc >= 2 * M + 4 * cfg.cp_len + 4 * D
        # a shard must cover its own left halo
        and Tloc >= coarse_left_halo(cfg)
        # the coarse stage has the all-streams rule only
        and cfg.sync_quorum is None
        and halo_impl == "ppermute"
    )
    col, row = _column(mesh), _row(mesh)
    home = mesh.home
    exchange = None
    if halo_impl == "pallas_dma" and n_time > 1 and col.spans_processes:
        exchange = halo_dma.ProcessHalo(col, S, M - 1)

    def stage_a(blocks):
        if coarse_ok:
            need_full, out = _coarse_sync_stage(blocks, col, cfg, T)
            if not bool(need_full):
                return out
        return _sync_stage(blocks, col, cfg, halo_impl, exchange)

    def derotate(blocks, eps, ref):
        return _per_block(mesh, lambda t, s: (t, id(blocks[t][s])),
                          lambda t, s: _derotate_stage(blocks[t][s], t, eps,
                                                       ref, M))

    def run(blocks) -> ShardedDecodeResult:
        if exchange is None:
            return decode(blocks)
        try:
            return decode(blocks)
        except BaseException as e:
            # the ranks' halo epochs may be apart now: later calls raise
            exchange.fail(f"a decode raised {e!r}")
            raise

    def decode(blocks) -> ShardedDecodeResult:
        for r in blocks:
            for b in r:
                if b is not None and tuple(b.shape) != (S, Tloc):
                    raise ValueError(f"shards must be [{S}, {Tloc}], got "
                                     f"{tuple(b.shape)}")
        first = [[blocks[t][0]] for t in range(n_time)]
        # ---- stage A ----
        t_star, starts, synced, corr_at, pmask = stage_a(first)
        t_star = torch.where(synced, t_star, 0)
        sync_index = torch.where(
            synced, schmidl_cox.sync_index_from(starts, pmask), 0)
        use_fb = torch.zeros_like(synced)
        if cfg.sync_fallback:
            fb_q, fb_p = _xcorr_stage(first, col, cfg, T)
            use_fb = ~synced & (fb_q > cfg.sync_fallback_threshold)
            synced = synced | use_fb
            sync_index = torch.where(use_fb, fb_p + M - cfg.cp_len, sync_index)
        cfo0 = torch.angle((-corr_at).sum()) / np.float32(np.pi)
        if cfg.correct_cfo:
            # the plateau correlation is garbage after a fallback sync:
            # that coarse estimate comes from the S0 halves below
            cfo0 = torch.where(use_fb, 0.0, cfo0)
            blocks = derotate(blocks, cfo0, 0.0)
            first = [[blocks[t][0]] for t in range(n_time)]

        # ---- stage B ----
        rstart = int(sync_index) - sym  # host read: the region start
        region = _home(coll.psum(coll.for_each(
            col, lambda t, s: _region_stage(first[t][s], t, rstart,
                                            region_len)), col), col)
        s0_idx, ac_idx = _mf_stage(region, row, cfg, joint)
        cfo_total = cfo0
        if cfg.correct_cfo:
            zero = torch.zeros_like(cfo0)
            eps_s0 = torch.where(
                use_fb, cfo_mod.s0_halves_cfo(region, s0_idx, cfg), zero)
            eps1 = cfo_mod.residual_cfo(
                schmidl_cox.correct_cfo(region, eps_s0, M)
                if cfg.sync_fallback else region, ac_idx, cfg)
            region = schmidl_cox.correct_cfo(region, eps_s0 + eps1, M)
            blocks = derotate(blocks, eps_s0 + eps1, float(np.float32(rstart)))
            s0_idx, ac_idx = _mf_stage(region, row, cfg, joint)
            cfo_total = cfo0 + eps_s0 + eps1
        G, nv = _estimate_stage(region, ac_idx, row, cfg, need_nv)
        if cfg.smooth_channel:
            G = smooth.smooth_channel_estimate(G, cfg)
        G_occ = G if all_occ else G[rx._occupied_on(cfg, G.device)]
        W, gain = weights_mod.weights_from(cfg, G_occ, nv)

        # ---- stage C ----
        decode_start = ac_idx[S - 1, -1] + M
        pstart = max(rstart + int(decode_start), 0)  # host read
        right = coll.ppermute_left(coll.for_each(
            mesh, lambda t, s: blocks[t][s][:, :sym]), mesh)
        parts = coll.for_each(mesh, lambda t, s: _payload_stage(
            blocks[t][s], right[t][s], t, s, pstart, cfg, n_sc,
            *(x.to(mesh.devices[t, s]) for x in (W, gain, G_occ)), fused))
        pid = cfg.pid_max
        if fused:
            sig = torch.zeros((S, pid, m_occ), dtype=torch.complex64,
                              device=home)
            data = torch.zeros((S, pid, m_occ), dtype=torch.int32,
                               device=home)
        else:
            grid = torch.zeros((pid, S, m_occ), dtype=torch.complex64,
                               device=home)
        for part in (p for prow in parts for p in prow if p is not None):
            k, n, y, d = part
            if n:
                rows = slice(k, k + n * n_sc, n_sc)
                if fused:
                    sig[:, rows] = y.to(home)
                    data[:, rows] = d.to(home)
                else:
                    grid[rows] = y.to(home)
        # each symbol has one owner: the other ranks' rows are zeros here
        if fused:
            sig = coll.sum_processes(sig, mesh)
            data = coll.sum_processes(data, mesh)
        else:
            grid = coll.sum_processes(grid, mesh)
        if not fused:
            if cfg.mode == CommMode.ALAMOUTI:
                eq = torch.zeros_like(grid)
                eq[:, 0, :] = alamouti.combine_pairs(grid, G_occ)
                grid = postprocess.postprocess_eq(eq, cfg)
            elif cfg.track_channel:
                eq, _ = tracking.track_and_equalize(
                    grid, G_occ, cfg, block_frames=cfg.track_block_frames,
                    alpha=cfg.track_alpha)
                grid = postprocess.postprocess_eq(eq, cfg)
            sig = grid.transpose(0, 1)
        rx_sig = sig.reshape(S, pid * m_occ)
        rx_data = (data.reshape(S, pid * m_occ) if fused else
                   constellation.demodulate(rx_sig, cfg.modulation))
        return ShardedDecodeResult(
            synced=synced, sync_index=sync_index, sync_sample=t_star,
            cfo_hat=cfo_total, G=G, decode_start=decode_start,
            rx_sig=rx_sig, rx_data=rx_data)

    def close() -> None:
        if exchange is not None:
            exchange.close()

    if input_format == "complex":
        run.close, run.exchange = close, exchange
        return run

    def run_planes(re_blocks, im_blocks) -> ShardedDecodeResult:
        return run(_per_block(
            mesh, lambda t, s: (id(re_blocks[t][s]), id(im_blocks[t][s])),
            lambda t, s: torch.complex(re_blocks[t][s], im_blocks[t][s])))

    run_planes.close, run_planes.exchange = close, exchange
    return run_planes
