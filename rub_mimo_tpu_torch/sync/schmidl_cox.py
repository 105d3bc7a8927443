"""Schmidl&Cox frame synchronization as whole-block tensor ops.

Port of rub_mimo_tpu/sync/schmidl_cox.py (the "coarse" path the decode
takes, plus the full scan it falls back to).  Per sample and stream
(framing.cc:626-637):

    corr[t]   = -sum_{k<M/2} conj(x[t-k-M/2]) x[t-k]
    energy[t] = 0.5 * sum_{k<M} |x[t-k]|^2
    metric[t] = |corr[t]|^2 / energy[t]^2

and sync fires at the first sample where every stream (or cfg.sync_quorum
streams) has held metric > threshold for more than cp_len samples;
sync_index = floor(mean of the run starts) (framing.cc:601-623).

Three implementations, as in the JAX package (``synchronize(impl=)``):
"coarse" (coarse+refine scan with the prefix early exit, the default),
"xla" (the full-rate scan: the metric of the whole capture, from K6 on
CUDA) and "pallas" (the one-pass kernel K5 on CUDA).  Each ``lax.cond``
of the coarse path becomes a Python ``if`` on a 0-d tensor — a host
synchronization on a GPU: one in the prefix early exit and one in the
coarse scan's exactness fallback; the other two read nothing back.  The
tile-aligned MXU block-sum form of the JAX package (a TPU layout
workaround) is dropped.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch
import torch.nn.functional as F

from rub_mimo_tpu_torch.config import ModemConfig
from rub_mimo_tpu_torch.kernels import sc_metric as k6
from rub_mimo_tpu_torch.kernels import sc_sync as k5
from rub_mimo_tpu_torch.kernels.sc_sync import plateau_scan

IMPLS = ("coarse", "xla", "pallas")


class SyncResult(NamedTuple):
    """What the reference's sync stage reports (main.cc:1430-1440)."""

    synced: torch.Tensor         # bool — did sync fire anywhere
    sync_sample: torch.Tensor    # int64 — sample at which sync fired (t*)
    sync_index: torch.Tensor     # int64 — floor(mean of run starts)
    plateau_start: torch.Tensor  # int64[streams] — run start at t*
    plateau_end: torch.Tensor    # int64[streams] — == t*
    cfo_hat: torch.Tensor        # float32 — CFO estimate, subcarrier units
    metric: Optional[torch.Tensor] = None  # float32[streams, T] if kept


def sc_metric(x: torch.Tensor, M: int, *, block: int = 1 << 15):
    """S&C timing metric for rows x [..., T] complex: (metric float32,
    corr complex64 — the un-squared moving correlation, for CFO)."""
    corr, energy = k6.moving_corr_energy(x, M, block=block)
    return k6.metric_from(corr, energy), corr


def _metric_from_slice(win: torch.Tensor, M: int):
    """Exact metric and corr of a capture slice that holds its own M-1
    samples of left context: valid from index M-1 on (from 0 when the
    slice starts at the capture's first sample)."""
    return sc_metric(win, M, block=win.shape[-1])


def sync_index_from(starts: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """floor-mean of the participating streams' run starts (the
    reference's all-streams mean, framing.cc:616, for a full mask)."""
    n = torch.clamp(mask.sum(), min=1)
    return torch.div(torch.where(mask, starts, 0).sum(), n,
                     rounding_mode="floor")


def _cfo_from(c_at: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """CFO in subcarrier units from the participating streams' plateau
    correlations: the delayed product turns by pi*eps over the M/2 lag;
    the extra pi of the negated taps (framing.cc:342) is removed by -.
    Negating before the sum keeps the no-fire value at angle(+0) = 0."""
    total = (-torch.where(mask, c_at, 0)).sum()
    return torch.angle(total) / np.float32(np.pi)


def _coarse_stride(cfg: ModemConfig) -> int:
    """Largest power of two <= min(cp_len/2, M/2): any (cp+1)-sample
    plateau then covers two consecutive D-aligned coarse points, and
    the coarse metric at aligned points is the exact metric."""
    D = 1
    lim = min(cfg.cp_len // 2, cfg.M // 2)
    while D * 2 <= lim:
        D *= 2
    return D


def coarse_block_sums(x: torch.Tensor, M2: int, nD: int, D: int):
    """Per-D-block sums of the S&C delayed product and energy over
    x[:, :nD*D]: ([S, nD] complex, [S, nD] float32)."""
    S = x.shape[0]
    n_full = nD * D
    prod = torch.conj(x[:, : n_full - M2]) * x[:, M2:n_full]
    prod = F.pad(prod, (M2, 0))
    xf = x[:, :n_full]
    e_in = xf.real ** 2 + xf.imag ** 2
    return (prod.reshape(S, nD, D).sum(dim=-1),
            e_in.reshape(S, nD, D).sum(dim=-1))


def _windows(x: torch.Tensor, starts: torch.Tensor, length: int):
    """x[:, s : s + length] for each start s of a device tensor [K]:
    [K, S, length], gathered without reading the starts on the host."""
    idx = starts.reshape(-1, 1) + torch.arange(length, device=x.device)
    return x[:, idx].transpose(0, 1)


def _run_lengths_fire(above: torch.Tensor, cp: int, q: int) -> torch.Tensor:
    """above [..., S, L] -> fire [..., L]: >= q streams each above for the
    whole cp+2 window ending at the position (per-stream runs)."""
    rl = torch.cumsum(above.to(torch.int32), dim=-1)
    rl = rl - F.pad(rl[..., : -(cp + 2)], (cp + 2, 0))
    return (rl >= cp + 2).sum(dim=-2) >= q


def _synchronize_coarse_prefix(x: torch.Tensor, cfg: ModemConfig,
                               block: int) -> SyncResult:
    """Run the coarse scan on a static prefix first; only when it shows
    no confident fire, scan the whole capture.  The fire condition is
    causal and local, so a fire at t* < Tpre - margin inside the prefix
    is the global first fire.  ``if ok`` is a host sync."""
    S, T = x.shape
    margin = 2 * cfg.M + 2 * cfg.cp_len
    Tpre = max(1 << 18, 8 * margin)
    if Tpre + margin >= T:
        return _synchronize_coarse(x, cfg, block)
    pre = _synchronize_coarse(x[:, :Tpre], cfg, block)
    if bool(pre.synced & (pre.sync_sample < Tpre - margin)):
        return pre
    return _synchronize_coarse(x, cfg, block)


def _synchronize_coarse(x: torch.Tensor, cfg: ModemConfig,
                        block: int) -> SyncResult:
    """Sync in ~3 passes over the capture (see the JAX package for the
    full derivation):

      1. COARSE: the exact metric at D-aligned positions t_i = i*D + D-1
         from per-block partial sums.
      2. CANDIDATES: a fire needs two consecutive coarse points above
         threshold; the first K=4 candidate pairs are refined with
         exact-metric windows, plus an exact scan of the capture tail.
      3. RUN STARTS: per-stream exact scan of a (2M+2cp)-sample window
         left of t*.

    Falls back to the full scan when the first K candidates all refine
    to no fire but more exist, or when a run extends past the run-start
    window (``if need_full``, a host sync) — the fast path never changes
    the result, only the speed."""
    S, T = x.shape
    dev = x.device
    M = cfg.M
    M2 = M // 2
    cp = cfg.cp_len
    thr = cfg.plateau_threshold
    q = S if cfg.sync_quorum is None else cfg.sync_quorum
    D = _coarse_stride(cfg)
    K = 4
    if D < 2 or M2 % D or T < 2 * M + 4 * cp + 4 * D:
        return _synchronize_full(x, cfg, block)

    nD = T // D
    kp, ke = M2 // D, M // D

    # ---- coarse pass: block-partial sums -> exact metric at t_i ----
    bs_p, bs_e = coarse_block_sums(x, M2, nD, D)

    def _mov(bs, k):
        cs = torch.cumsum(bs, dim=-1)
        return cs - F.pad(cs[:, :-k], (k, 0))

    corr_c = -_mov(bs_p, kp)
    e_c = 0.5 * _mov(bs_e, ke)
    metric_c = (corr_c.real ** 2 + corr_c.imag ** 2) / (e_c * e_c)
    all_c = (metric_c > thr).sum(dim=0) >= q            # [nD]
    pair = all_c[:-1] & all_c[1:]                       # pair j <-> (j, j+1)
    n_cand = pair.sum()
    big = T + 10 * M
    jidx = torch.arange(nD - 1, device=dev)
    cand_j = -torch.topk(torch.where(pair, -jidx, -big), K).values  # sorted

    # ---- refine the K candidates in one batched metric computation ----
    Lp = 2 * cp + 2                                     # metric positions
    Lw = (M - 1) + Lp                                   # slice length
    run_w = 2 * M + 2 * cp                              # run-start window
    Lr = (M - 1) + run_w

    t_i = (cand_j + 1) * D + D - 1                      # [K]
    p0 = t_i - cp - 1                                   # first metric pos
    cl = torch.clamp(p0 - (M - 1), 0, T - Lw)           # [K]
    m_w, _ = sc_metric(_windows(x, cl, Lw), M, block=Lw)  # [K, S, Lw]
    qs = torch.clamp((p0 - cl).unsqueeze(1)
                     + torch.arange(Lp, device=dev), 0, Lw - 1)  # [K, Lp]
    pos = cl.unsqueeze(1) + qs                          # [K, Lp]
    above_s = torch.gather(
        m_w, 2, qs.unsqueeze(1).expand(K, S, Lp)) > thr  # [K, S, Lp]
    fire_k = (_run_lengths_fire(above_s, cp, q)
              & (pos >= t_i.unsqueeze(1)) & (pos < T))  # [K, Lp]
    p_fire = torch.where(fire_k, pos, big).min(dim=1).values
    ok = (cand_j < nD - 1) & (t_i + cp < T)
    fires = torch.where(ok, p_fire, big)

    # ---- tail guard: fires whose coarse pair would fall past the grid ----
    Wt = 2 * cp + 4 * D + 2
    tail_cl = T - ((M - 1) + Wt + cp + 2)
    m_t, _ = sc_metric(x[:, tail_cl:], M, block=T - tail_cl)
    qs_t = (M - 1) + torch.arange(Wt + cp + 2, device=dev)
    pos_t = tail_cl + qs_t
    fire_t = (_run_lengths_fire(m_t[:, qs_t] > thr, cp, q)
              & (pos_t >= T - 2 * D - cp) & (pos_t < T))
    p_tail = torch.where(fire_t, pos_t, big).min()

    t_star = torch.minimum(fires.min(), p_tail)
    synced = t_star < big
    t_star = torch.where(synced, t_star, 0)

    # ---- per-stream run starts: exact scan left of t* ----
    r_cl = torch.clamp(t_star - run_w + 1 - (M - 1), 0, max(T - Lr, 0))
    m_r, corr_r = sc_metric(_windows(x, r_cl.reshape(1), Lr)[0], M, block=Lr)
    pos_r = r_cl + torch.arange(Lr, device=dev)
    in_scan = (pos_r <= t_star) & (pos_r > t_star - run_w)
    below = (~(m_r > thr)) & in_scan.unsqueeze(0)
    last_below = torch.where(below, pos_r.unsqueeze(0), -1).max(dim=1).values
    starts = last_below + 1
    # a run reaching past the window start is only exact when the window
    # already begins at sample 0
    run_saturated = (synced & (t_star - run_w + 1 > 0)
                     & (last_below == -1).any())
    at = (t_star - r_cl).reshape(1, 1).expand(S, 1)
    c_at = torch.gather(corr_r, 1, at)[:, 0]
    m_at = torch.gather(m_r, 1, at)[:, 0]
    mask = (m_at > thr) & ((t_star - starts) > cp)

    # no-fire defaults match the full scan's (t*=0 -> corr 0, starts 1)
    starts = torch.where(synced, starts, 1)
    c_at = torch.where(synced, c_at, 0)
    if q == S:
        mask = torch.ones_like(mask)
    mask = (mask & synced) | ~synced

    need_full = run_saturated | (~synced & (n_cand > K))
    if bool(need_full):
        return _synchronize_full(x, cfg, block)
    return SyncResult(
        synced=synced, sync_sample=t_star,
        sync_index=sync_index_from(starts, mask),
        plateau_start=starts, plateau_end=t_star.expand(S),
        cfo_hat=_cfo_from(c_at, mask),
    )


def corr_at(x: torch.Tensor, t: torch.Tensor, M: int) -> torch.Tensor:
    """corr[:, t] for x [S, T] and a device scalar t, from the plain S&C
    sums over the M samples that end at t (zeros before sample 0): the
    lag products it sums need no earlier sample."""
    idx = t - (M - 1) + torch.arange(M, device=x.device)
    win = torch.where(idx >= 0, x[:, idx.clamp(min=0)], 0)
    return k6.moving_corr_energy(win, M, block=M)[0][:, -1]


def _synchronize_full(x: torch.Tensor, cfg: ModemConfig, block: int,
                      keep_metric: bool = False) -> SyncResult:
    """The full-rate scan: the metric of the whole capture (K6 on CUDA),
    the plateau scan, and the correlation at t*."""
    metric = k6.sc_metric_fused(x, cfg.M, block=block)
    synced, t_star, starts, mask = plateau_scan(
        metric, cfg.cp_len, cfg.plateau_threshold, cfg.sync_quorum)
    return SyncResult(
        synced=synced, sync_sample=t_star,
        sync_index=sync_index_from(starts, mask),
        plateau_start=starts, plateau_end=t_star.expand(cfg.num_streams),
        cfo_hat=_cfo_from(corr_at(x, t_star, cfg.M), mask),
        metric=metric if keep_metric else None,
    )


def _synchronize_kernel(x: torch.Tensor, cfg: ModemConfig,
                        block: int) -> SyncResult:
    """The one-pass sync K5 (all-streams rule): sync_index is the floor
    mean of every stream's run start, the CFO comes from every stream's
    correlation at t* (schmidl_cox.py:524-543 of the JAX package)."""
    S = cfg.num_streams
    synced, t_star, starts, c_at = k5.sc_sync_fused(
        x, cfg.M, cfg.cp_len, cfg.plateau_threshold, block=block)
    return SyncResult(
        synced=synced, sync_sample=t_star,
        sync_index=torch.div(starts.sum(), S, rounding_mode="floor"),
        plateau_start=starts, plateau_end=t_star.expand(S),
        cfo_hat=_cfo_from(c_at, torch.ones_like(synced).expand(S)),
    )


def synchronize(x: torch.Tensor, cfg: ModemConfig, *,
                keep_metric: bool = False, block: int = 1 << 15,
                impl: str = "coarse") -> SyncResult:
    """Sync stage of x [S, T] complex, with the JAX package's impl names:
    "coarse" (coarse+refine scan with the prefix early exit), "xla" (the
    full-rate scan) or "pallas" (the one-pass kernel K5).  keep_metric
    takes the full-rate scan and returns its metric, except under
    "pallas", which keeps no metric; a sync_quorum config turns "pallas"
    into "coarse" (K5 has the all-streams rule only)."""
    if impl not in IMPLS:
        raise ValueError(f"unknown sync impl {impl!r}; expected one of "
                         f"{IMPLS}")
    if cfg.sync_quorum is not None and impl == "pallas":
        impl = "coarse"
    if impl == "pallas":
        return _synchronize_kernel(x, cfg, block)
    if impl == "coarse" and not keep_metric:
        return _synchronize_coarse_prefix(x, cfg, block)
    return _synchronize_full(x, cfg, block, keep_metric)


def correct_cfo(x: torch.Tensor, cfo_subcarriers: torch.Tensor,
                M: int) -> torch.Tensor:
    """De-rotate x [..., T] by a CFO in subcarrier-spacing units (a device
    scalar): x[t] exp(-2 pi i cfo t / M), t counted as float32 as in the
    JAX package (schmidl_cox.py:551-558)."""
    n = torch.arange(x.shape[-1], dtype=torch.float32, device=x.device)
    rot = torch.exp(-2j * np.pi * cfo_subcarriers * n / M)
    return (x * rot).to(torch.complex64)
