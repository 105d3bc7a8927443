"""Streaming (online, chunked) decode with carried state.

Port of rub_mimo_tpu/pipeline/streaming.py.  IQ arrives in chunks of
``chunk_size`` samples a stream; a host-side phase machine drives eager
device steps, and every piece of heavy state stays on the decoder's
device:

  SEEK     the S&C metric of the chunk with an (M-1)-sample carried tail
           (K6, kernels.sc_metric, on CUDA) and the plateau rule with a
           carried last-below index per stream; fires exactly like the
           offline full-rate scan.  One host read a chunk (did it fire);
           ``push_block`` seeks K chunks with one read.
  COLLECT  the chunk's overlap with the estimation region [S, region_len]
           (one symbol before sync_index) is added in by one slice.
  (estimate) matched filter, LS channel, smoothing and detector weights
           on the filled region, with the residual CFO when configured.
  PAYLOAD  chunks go through a ring on the device; each C-sample block
           decodes the OFDM symbols whose last sample lies in it (unique
           ownership), read from a carried (symbol_len-1)-sample tail:
           one contiguous run of symbols, stripped and decoded by K1
           (kernels.payload_fused.payload_fused_strip) where the payload
           kernels apply, else by K7 (kernels.cp_strip), the FFT and the
           generic tail (channel tracking decides with K4).  No host read.

A burst whose payload is complete is recorded in ``bursts`` and the
machine re-arms: the chunk-aligned tail of the ring is replayed through
the seek, so a following burst is found too.  Positions are host ints;
the frames stay on the device.  ``host_reads`` counts the device-to-host
reads the decoder made.

Live SFO correction (sfo_correct, with track_channel): each tracked
payload block adds the offline estimator's frame-differential moment z
(estimate.sfo) of its statically equalized frames against the tracked
decisions, on the device with no read.  At a re-arm z is fitted (one
read) and folded into ``sfo_hat``, and a StreamingResampler
(utils.resample) engages at the replay's start, preloaded with raw
history: the replay and every later chunk go through it, so the next
bursts decode from the corrected stream.

Blind front-end compensation (frontend_comp): the first warmup_chunks
chunks are held on the device, the DC offset and IQ imbalance moments
(estimate.frontend) are estimated over them, and they are replayed
compensated; every later chunk (and push_block's blocks) is compensated
before the seek.  The moments and the compensation stay on the device:
no host read.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, NamedTuple, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from rub_mimo_tpu_torch.config import CommMode, ModemConfig, check_config
from rub_mimo_tpu_torch.detect import (alamouti, dispatch, postprocess,
                                       tracking, zf)
from rub_mimo_tpu_torch.detect import weights as weights_mod
from rub_mimo_tpu_torch.estimate import cfo as cfo_mod
from rub_mimo_tpu_torch.estimate import frontend, ls, smooth
from rub_mimo_tpu_torch.estimate import sfo as sfo_mod
from rub_mimo_tpu_torch.kernels import cp_strip as cp_strip_mod
from rub_mimo_tpu_torch.kernels import payload_fused
from rub_mimo_tpu_torch.kernels import sc_metric as k6
from rub_mimo_tpu_torch.kernels import sc_sync as k5
from rub_mimo_tpu_torch.ofdm import constellation
from rub_mimo_tpu_torch.pipeline import rx
from rub_mimo_tpu_torch.sync import matched_filter, schmidl_cox, xcorr_sync
from rub_mimo_tpu_torch.utils import resample
from rub_mimo_tpu_torch.utils.device import on_device
from rub_mimo_tpu_torch.utils.device_cache import device_constant
from rub_mimo_tpu_torch.utils.movsum import moving_sum

Frames = List[Tuple[int, torch.Tensor]]


@dataclasses.dataclass
class BurstRecord:
    """Snapshot of one completed frame burst (multi-burst streaming)."""

    sync_index: int
    decode_start: int
    cfo_hat: float
    frames: Dict[int, torch.Tensor]  # k -> [S, M_occ] complex64
    G: Optional[torch.Tensor]
    fb_used: bool


@device_constant
def _ramp(n: int, dtype: torch.dtype, device: torch.device) -> torch.Tensor:
    """[n] 0, 1, ..., n - 1 on ``device``, made once."""
    return torch.arange(n, dtype=dtype, device=device)


class _SeekStep(NamedTuple):
    """One chunk's seek step: the carried state after it and what a fire
    needs (all on the device)."""

    tail: torch.Tensor        # [S, M-1], the chunk's last samples
    last_below: torch.Tensor  # [S] int64, global
    fired: torch.Tensor       # bool
    t_loc: torch.Tensor       # [1], the first fire's offset in the chunk
    run_start: torch.Tensor   # [S, C] int64, global
    cond: torch.Tensor        # [S, C] bool, each stream's fire condition
    ext: torch.Tensor         # [S, M-1+C], [carried tail, chunk]


class StreamingDecoder:
    def __init__(self, cfg: ModemConfig, *, device,
                 chunk_size: int = 1 << 16, frontend_comp: bool = False,
                 warmup_chunks: int = 4, sfo_correct: bool = False):
        """A chunked decoder of cfg's frames on ``device`` (a CUDA request
        without CUDA raises).  Chunks are [num_streams, chunk_size],
        chunk_size >= symbol_len.  sfo_correct (which needs
        cfg.track_channel) corrects the sampling-clock offset live, from
        the second burst on; frontend_comp compensates the DC offset and
        IQ imbalance estimated over the first warmup_chunks chunks (see
        the module note)."""
        check_config(cfg, "StreamingDecoder")
        cfg.validate()
        self._fe_on = bool(frontend_comp)
        self._fe_warmup = int(warmup_chunks)
        self._fe_buf: List[torch.Tensor] = []
        self._fe_dc = self._fe_w = None
        self._sfo_on = bool(sfo_correct)
        if self._sfo_on and not cfg.track_channel:
            raise ValueError(
                "sfo_correct requires cfg.track_channel=True (the tracked "
                "refits are both the live equalizer under drift and the "
                "SFO observable)")
        self.cfg = cfg
        self.device = on_device(device)
        self.C = int(chunk_size)
        S, M, sym = cfg.num_streams, cfg.M, cfg.symbol_len
        self.S = S
        if self.C < sym:
            raise ValueError("chunk_size must be >= symbol_len")
        self.region_len = sym * (1 + cfg.num_access_codes * S) + M
        # backfill depth at the sync transition: the region can start up
        # to ~(symbol_len + plateau width) before the fire sample, which
        # may itself be early in the chunk
        self._recent_len = self.C + sym + 2 * M
        self._ring_len = self.region_len + 3 * self.C
        self.m_occ = cfg.M_occupied
        self._joint = (not cfg.bit_exact) and cfg.timing_mode == "joint"
        self._use_k1 = rx.kernel_applicable(cfg, "auto")
        self._table = constellation.table(cfg.modulation)
        self._nloc = self.C // sym + 1
        # live SFO estimation needs groups fine enough for the tracker to
        # out-pace the ramp (decode_with_sfo's rule)
        gf = (min(cfg.track_block_frames, 4) if self._sfo_on
              else cfg.track_block_frames)
        self._gf = max(1, min(gf, self._nloc))
        self.host_reads = 0
        self.gpos = 0  # global samples consumed
        self.bursts: List[BurstRecord] = []
        self._ring = self._zeros(self._ring_len)
        # the burst being acquired; a re-arm leaves these (and the public
        # W, gain and G) standing until a new burst overwrites them
        self._cur_synced = False
        self._cur_sync_index: Optional[int] = None
        self._cur_decode_start: Optional[int] = None  # global frame-0 CP
        self._cur_cfo_hat = 0.0  # accumulated CFO estimate (subcarriers)
        self.region_start: Optional[int] = None
        self.W = self.gain = self.G = self._G_occ = None
        self._reset()
        self._in_replay = False  # re-arm replay in progress
        # live SFO: the accumulated fractional-rate estimate (host), the
        # resampler (engaged at the first re-arm) and the moment z
        self.sfo_hat = 0.0
        self._resampler: Optional[resample.StreamingResampler] = None
        self._sfo_z = torch.zeros((self.m_occ,), dtype=torch.complex64,
                                  device=self.device)

    def _zeros(self, n: int) -> torch.Tensor:
        return torch.zeros((self.S, n), dtype=torch.complex64,
                           device=self.device)

    def _reset(self) -> None:
        """The phase machine's state, as at the start of a stream."""
        cfg = self.cfg
        self._tail = self._zeros(cfg.M - 1)
        self._recent = self._zeros(self._recent_len)
        self._last_below = torch.full((self.S,), -1, dtype=torch.int64,
                                      device=self.device)
        self.phase = "seek"
        self._region = self._zeros(self.region_len)
        self._ptail = self._zeros(cfg.symbol_len - 1)
        self.frames: Dict[int, torch.Tensor] = {}
        self._pend: Dict[int, torch.Tensor] = {}  # raw Y awaiting its pair
        self._q_r = self._q_w = self._q_count = 0
        self._q_gpos = 0  # global position of the sample at _q_r
        self._eps0 = 0.0  # coarse rotation applied to incoming data
        self._eps_r = 0.0  # post-estimation rotation (ref region_start)
        self._fb_used = False
        self._burst_end: Optional[int] = None  # global end of the payload

    # -- public view: the FIRST burst's attributes; the live _cur_* fields
    # track the burst being acquired ---------------------------------- #
    @property
    def synced(self) -> bool:
        return True if self.bursts else self._cur_synced

    @property
    def sync_index(self) -> Optional[int]:
        return (self.bursts[0].sync_index if self.bursts
                else self._cur_sync_index)

    @property
    def decode_start(self) -> Optional[int]:
        return (self.bursts[0].decode_start if self.bursts
                else self._cur_decode_start)

    @property
    def cfo_hat(self) -> float:
        return self.bursts[0].cfo_hat if self.bursts else self._cur_cfo_hat

    # ------------------------------------------------------------------ #
    def _read(self, t: torch.Tensor):
        """One device-to-host read (a Python scalar or list)."""
        self.host_reads += 1
        return t.item() if t.dim() == 0 else t.tolist()

    def _to_device(self, x) -> torch.Tensor:
        return torch.as_tensor(x, dtype=torch.complex64, device=self.device)

    def _seek_step(self, tail, last_below, chunk, gpos: int) -> _SeekStep:
        """The S&C metric of [tail, chunk] (K6 on CUDA), kept from the
        chunk's first sample, and the plateau rule with the carried last
        below-threshold index folded in by a max."""
        cfg, C, M = self.cfg, self.C, self.cfg.M
        ext = torch.cat([tail, chunk], dim=-1)  # [S, M-1+C]
        metric = k6.sc_metric_fused(ext, M, block=min(1 << 15, C + M - 1))
        metric = metric[:, M - 1:]
        gidx = _ramp(C, torch.int64, self.device) + gpos
        above = metric > cfg.plateau_threshold  # NaN > thr is False
        lb = torch.maximum(k5.cummax(torch.where(above, -1, gidx)),
                           last_below[:, None])
        run_start = lb + 1
        cond = above & ((gidx - run_start) > cfg.cp_len)
        q = self.S if cfg.sync_quorum is None else cfg.sync_quorum
        cond_all = cond.sum(dim=0) >= q
        t_loc = torch.argmax(cond_all.to(torch.uint8)).reshape(1)
        return _SeekStep(ext[:, -(M - 1):], lb[:, -1], cond_all.any(), t_loc,
                         run_start, cond, ext)

    def _fallback(self, ext: torch.Tensor) -> Tuple[float, int]:
        """The normalized S0 cross-correlation over the windows starting in
        [gpos - (M-1), gpos + C - M] of ext = [tail, chunk]: (best score,
        its index in ext), one read.  Windows holding almost no energy
        (under 5 % of the chunk's strongest) are excluded: a window of a
        few isolated samples scores like the template's self-peak."""
        C, M = self.C, self.cfg.M
        score = xcorr_sync.normalized_s0_score(ext, self.cfg, C)
        e_win = moving_sum(ext.real ** 2 + ext.imag ** 2, M)
        e_fwd = torch.roll(e_win, -(M - 1), dims=-1)[:, :C].sum(dim=0)
        score = torch.where(e_fwd > 0.05 * e_fwd.max(), score, 0.0)
        j = torch.argmax(score)
        q, jh = self._read(torch.stack([score[j].double(), j.double()]))
        return q, int(jh)

    def _derotate(self, data: torch.Tensor, eps: float, start_gpos: int,
                  ref: float) -> torch.Tensor:
        """data[g] exp(-2j pi eps (g - ref) / M), g the global position
        from start_gpos, counted in float32 (float32(start) + arange) as
        the JAX package counts it, so the phase agrees across chunks."""
        n = data.shape[-1]
        g = (_ramp(n, torch.float32, self.device)
             + float(np.float32(start_gpos)))
        e = torch.full((), float(np.float32(eps)), dtype=torch.float32,
                       device=self.device)
        rot = torch.exp(-2j * np.pi * e * (g - float(np.float32(ref)))
                        / self.cfg.M)
        return (data * rot).to(torch.complex64)

    def _coarse(self, data: torch.Tensor, start_gpos: int) -> torch.Tensor:
        """data with the coarse CFO rotation removed (when there is one)."""
        if self.cfg.correct_cfo and self._eps0 != 0.0:
            return self._derotate(data, self._eps0, start_gpos, 0.0)
        return data

    def _place(self, data: torch.Tensor, data_gpos: int) -> None:
        """Add data (global start data_gpos) into the region buffer where
        they overlap."""
        lo = max(self.region_start, data_gpos)
        hi = min(self.region_start + self.region_len,
                 data_gpos + data.shape[-1])
        if hi > lo:
            self._region[:, lo - self.region_start:hi - self.region_start] += (
                data[:, lo - data_gpos:hi - data_gpos])

    # ------------------------------------------------------------------ #
    def push(self, chunk) -> Frames:
        """Feed one [S, chunk_size] chunk (numpy or tensor; moved to the
        decoder's device); returns the newly decoded frames as
        (frame index, [S, M_occupied] complex64 tensor) pairs."""
        if tuple(chunk.shape) != (self.S, self.C):
            raise ValueError(f"chunk must be [{self.S}, {self.C}], got "
                             f"{tuple(chunk.shape)}")
        chunk = self._to_device(chunk)
        if self._fe_on:
            if self._fe_dc is None:
                # warm-up: held (a copy: the caller may reuse its buffer)
                # until the moments can be estimated
                self._fe_buf.append(chunk.clone())
                if len(self._fe_buf) < self._fe_warmup:
                    return []
                return self._fe_start()
            chunk = frontend.compensate(chunk, self._fe_dc, self._fe_w)
        return self._push_compensated(chunk)

    def _push_compensated(self, chunk: torch.Tensor) -> Frames:
        if self._resampler is None:
            return self._push_inner(chunk)
        # live SFO engaged: the decoder takes the resampler's output
        # chunks, which lag the input by its window's lookahead
        emitted: Frames = []
        for c in self._resampler.push(chunk):
            emitted += self._push_inner(c)
        return emitted

    def _fe_start(self) -> Frames:
        """Estimate the front-end moments over the warm-up chunks (on the
        device), then replay them compensated."""
        self._fe_dc, self._fe_w = frontend.estimate_frontend(
            torch.cat(self._fe_buf, dim=-1))
        emitted: Frames = []
        for c in self._fe_buf:
            emitted += self._push_compensated(
                frontend.compensate(c, self._fe_dc, self._fe_w))
        self._fe_buf = []
        return emitted

    def push_block(self, samples) -> Frames:
        """Feed K chunks at once ([S, K*chunk_size], numpy or tensor,
        moved to the device once).

        While the decoder is seeking, each chunk's seek step runs on the
        device with no read in between, and the K fired flags are read
        once (after the front-end compensation, when it is on).  With no
        fire the scanned state is committed; on a fire (or in any other
        phase, for K = 1, with the fallback sync, which needs per-chunk
        host logic, during the front end's warm-up, or with the live SFO
        resampler engaged) the block goes chunk by chunk through the
        ordinary path from the unchanged state, so the result equals
        chunk-at-a-time feeding."""
        C = self.C
        shape = tuple(samples.shape)
        if len(shape) != 2 or shape[0] != self.S or shape[1] % C:
            raise ValueError(f"push_block needs [{self.S}, K*{C}] samples, "
                             f"got {shape}")
        K = shape[1] // C
        x = self._to_device(samples)
        chunks = [x[:, k * C:(k + 1) * C] for k in range(K)]
        fast_ok = (self.phase == "seek" and K > 1
                   and not self.cfg.sync_fallback and self._resampler is None
                   and not (self._fe_on and self._fe_dc is None))
        if not fast_ok:
            emitted: Frames = []
            for c in chunks:
                emitted += self.push(c)
            return emitted
        if self._fe_on:
            x = frontend.compensate(x, self._fe_dc, self._fe_w)
            chunks = [x[:, k * C:(k + 1) * C] for k in range(K)]
        tail, lb, g, fired = self._tail, self._last_below, self.gpos, []
        for c in chunks:
            st = self._seek_step(tail, lb, c, g)
            tail, lb, g = st.tail, st.last_below, g + C
            fired.append(st.fired)
        if not self._read(torch.stack(fired).any()):
            # no sync in the whole block: commit the scanned state
            self._tail, self._last_below = tail, lb
            self._recent = torch.cat([self._recent, x],
                                     dim=-1)[:, -self._recent_len:]
            self.gpos = g
            return []
        emitted = []
        for c in chunks:
            emitted += self._push_inner(c)
        return emitted

    def _push_inner(self, chunk: torch.Tensor) -> Frames:
        cfg, C, M = self.cfg, self.C, self.cfg.M
        gpos = self.gpos
        if self.phase == "seek":
            st = self._seek_step(self._tail, self._last_below, chunk, gpos)
            self._tail, self._last_below = st.tail, st.last_below
            fired = bool(self._read(st.fired))
            fb_fired = False
            # the fallback is suppressed while replaying the re-arm window:
            # it would rescan the previous burst's payload tail, which the
            # offline multi-burst decode erases
            if not fired and cfg.sync_fallback and not self._in_replay:
                q, jrel = self._fallback(st.ext)
                if q > cfg.sync_fallback_threshold:
                    fb_fired = True
                    self._cur_sync_index = gpos - (M - 1) + jrel + M - cfg.cp_len
            self._recent = torch.cat([self._recent, chunk],
                                     dim=-1)[:, -self._recent_len:]
            if fired or fb_fired:
                self._on_fire(st if fired else None, gpos)
        elif self.phase == "collect":
            self._place(self._coarse(chunk, gpos), gpos)
        elif self.phase == "payload":
            self._enqueue(self._coarse(chunk, gpos), gpos)
        self.gpos = gpos + C

        if (self.phase == "collect"
                and self.gpos >= self.region_start + self.region_len):
            self._estimate(chunk, gpos)
        return self._drain()

    def _on_fire(self, st: Optional[_SeekStep], gpos: int) -> None:
        """Sync fired in the chunk at gpos (st None: the fallback fired):
        the sync index and coarse CFO (one read), then the region's
        backfill from the recent buffer."""
        cfg, S, M = self.cfg, self.S, self.cfg.M
        self._cur_synced = True
        self._fb_used = st is None
        if st is not None:
            at = st.t_loc
            parts = [st.run_start.index_select(1, at)[:, 0].double(),
                     st.cond.index_select(1, at)[:, 0].double()]
            if cfg.correct_cfo:
                ca = schmidl_cox.corr_at(st.ext, at[0] + (M - 1), M)
                parts += [ca.real.double(), ca.imag.double()]
            h = self._read(torch.cat(parts))
            starts = [int(v) for v in h[:S]]
            # the participating streams: all of them under the
            # all-streams rule, at least sync_quorum otherwise
            mask = [bool(v) for v in h[S:2 * S]]
            n = max(sum(mask), 1)
            self._cur_sync_index = sum(s for s, m in zip(starts, mask)
                                       if m) // n
            if cfg.correct_cfo:
                ca = (np.asarray(h[2 * S:3 * S], np.float32)
                      + 1j * np.asarray(h[3 * S:], np.float32)).astype(
                          np.complex64)
                self._eps0 = float(np.angle(np.sum(-ca[np.asarray(mask)]))
                                   / np.pi)
        self.region_start = self._cur_sync_index - cfg.symbol_len
        self.phase = "collect"
        # the recent buffer already holds this chunk; derotate raw samples
        # at placement
        rec_gpos = gpos + self.C - self._recent_len
        self._place(self._coarse(self._recent, rec_gpos), rec_gpos)

    def _estimate(self, chunk: torch.Tensor, gpos: int) -> None:
        """The region is complete: (residual CFO,) channel, weights and the
        payload start (one read, two more with the CFO), then seed the
        payload ring with the region and this chunk's overshoot."""
        cfg, S = self.cfg, self.S
        region = self._region
        if cfg.correct_cfo:
            # as the offline decode: the S0-halves coarse estimate after a
            # fallback sync, then the access-code residual; phase reference
            # the region's start
            mf = matched_filter.search(region, cfg, joint=self._joint)
            eps_s0 = 0.0
            if self._fb_used:
                eps_s0 = self._read(cfo_mod.s0_halves_cfo(region, mf.s0_index,
                                                          cfg))
            probe = region
            if cfg.sync_fallback and eps_s0 != 0.0:
                probe = self._derotate(region, eps_s0, 0, 0.0)
            self._eps_r = eps_s0 + self._read(
                cfo_mod.residual_cfo(probe, mf.ac_index, cfg))
            if self._eps_r != 0.0:
                region = self._derotate(region, self._eps_r, 0, 0.0)
            self._cur_cfo_hat = self._eps0 + self._eps_r
        mf = matched_filter.search(region, cfg, joint=self._joint)
        G = ls.estimate_channel(region, mf.ac_index, cfg)
        if cfg.smooth_channel:
            G = smooth.smooth_channel_estimate(G, cfg)
        self.G, self._G_occ = G, rx.occupied_channel(G, cfg)
        self.W, self.gain = weights_mod.weights_for(cfg, G, self._G_occ,
                                                    region, mf.ac_index)
        self._cur_decode_start = self.region_start + self._read(
            mf.ac_index[S - 1, -1] + cfg.M)
        self._burst_end = self._cur_decode_start + cfg.pid_max * cfg.symbol_len
        self.phase = "payload"
        # everything consumed so far lives in the region buffer, and
        # possibly an overshoot of this chunk past the region's end
        region_end = self.region_start + self.region_len
        self._q_r = self._q_w = self._q_count = 0
        self._q_gpos = self.region_start
        self._enqueue(self._region, self.region_start)
        overshoot = self.gpos - region_end
        if overshoot > 0:
            # the payload ring lives in coarse-derotated space
            self._enqueue(self._coarse(chunk, gpos), region_end,
                          start=self.C - overshoot, n=overshoot)

    # -- the payload ring ---------------------------------------------- #
    def _enqueue(self, data: torch.Tensor, data_gpos: int, start: int = 0,
                 n: Optional[int] = None) -> None:
        """Append data[:, start:start+n] to the ring (one or two slice
        copies where it wraps)."""
        if n is None:
            n = int(data.shape[-1]) - start
        if n <= 0:
            return
        if self._q_count and data_gpos != self._q_gpos + self._q_count:
            raise AssertionError("payload queue must stay contiguous")
        if self._q_count == 0:
            self._q_gpos = int(data_gpos)
        L = self._ring_len
        if self._q_count + n > L:
            raise AssertionError("payload ring overflow")
        w = self._q_w
        first = min(n, L - w)
        self._ring[:, w:w + first] = data[:, start:start + first]
        if n > first:
            self._ring[:, :n - first] = data[:, start + first:start + n]
        self._q_w = (w + n) % L
        self._q_count += n

    def _ring_read(self, r: int) -> torch.Tensor:
        """The C ring samples from offset r (a view, or a copy where the
        read wraps)."""
        C, L = self.C, self._ring_len
        if r + C <= L:
            return self._ring[:, r:r + C]
        return torch.cat([self._ring[:, r:], self._ring[:, :r + C - L]],
                         dim=-1)

    def _dequeue(self) -> Tuple[torch.Tensor, int]:
        data, gp = self._ring_read(self._q_r), self._q_gpos
        self._q_r = (self._q_r + self.C) % self._ring_len
        self._q_count -= self.C
        self._q_gpos += self.C
        return data, gp

    def _drain(self) -> Frames:
        """Consume the payload queue in C-sample blocks.  A block that
        covers the burst's last payload sample completes the burst: record
        it and re-arm."""
        out: Frames = []
        while self.phase == "payload" and self._q_count >= self.C:
            data, gp = self._dequeue()
            out += self._payload_block(data, gp)
            if gp + self.C >= self._burst_end:
                out += self._rearm()
        return out

    def _rearm(self) -> Frames:
        """Burst complete: record it, reset to SEEK, and replay the
        chunk-aligned tail of the ring (every sample from the last chunk
        boundary at or before the payload's end) through the seek at its
        global positions, so a preamble already received is not dropped.
        The ring's capacity exceeds the queue's largest backlog by two
        chunks, so it still holds them (asserted)."""
        end, gpos0, C, L = self._burst_end, self.gpos, self.C, self._ring_len
        self.bursts.append(BurstRecord(
            sync_index=int(self._cur_sync_index),
            decode_start=int(self._cur_decode_start),
            cfo_hat=float(self._cur_cfo_hat), frames=self.frames, G=self.G,
            fb_used=self._fb_used))
        k = max(0, -(-(gpos0 - end) // C))
        replay_start = gpos0 - k * C
        chunks = []
        for i in range(k):
            g = replay_start + i * C
            assert gpos0 - g <= L, "re-arm replay out of ring"
            # copied out: the replay writes the ring again
            chunks.append(self._raw_chunk(g).clone())
        if self._sfo_on:
            chunks = self._sfo_rearm(chunks, replay_start, gpos0)
        self._reset()
        emitted: Frames = []
        self.gpos = replay_start
        self._in_replay = True
        try:
            for data in chunks:
                emitted += self._push_inner(data)
        finally:
            self._in_replay = False
        assert self.gpos <= gpos0, "re-arm replay position mismatch"
        return emitted

    def _raw_chunk(self, g: int) -> torch.Tensor:
        """The ring's C samples from global position g, the burst's coarse
        derotation undone (a view where nothing is undone)."""
        data = self._ring_read((self._q_r + (g - self._q_gpos))
                               % self._ring_len)
        if self.cfg.correct_cfo and self._eps0 != 0.0:
            data = self._derotate(data, -self._eps0, g, 0.0)
        return data

    def _sfo_rearm(self, chunks: List[torch.Tensor], replay_start: int,
                   gpos0: int) -> List[torch.Tensor]:
        """Fit the burst's SFO moment (one read) into sfo_hat, engage or
        retune the resampler, and reset the moment.  The resampler engages
        at replay_start, not gpos0 (the next preamble may already sit in
        the replay, and the estimation region must not straddle a
        raw/resampled seam): its ring is preloaded with the raw history
        before replay_start, and the replay goes through it.  Returns the
        chunks to replay (the resampler's output lags by its lookahead)."""
        delta_inc = self._read(sfo_mod.fit_subcarrier_slope(self._sfo_z,
                                                            self.cfg))
        self._sfo_z = torch.zeros_like(self._sfo_z)
        if not np.isfinite(delta_inc) or delta_inc == 0.0:
            return chunks
        self.sfo_hat += delta_inc
        factor = 1.0 / (1.0 + self.sfo_hat)
        if self._resampler is not None:
            self._resampler.set_factor(factor)
            return chunks
        rs = resample.StreamingResampler(self.S, self.C, factor=factor,
                                         origin=replay_start,
                                         device=self.device)
        for i in range(-(-(rs.margin + 16) // self.C), 0, -1):
            g = replay_start - i * self.C
            if g < 0 or gpos0 - g > self._ring_len:
                continue
            rs.preload_history(self._raw_chunk(g), g)
        self._resampler = rs
        out: List[torch.Tensor] = []
        for data in chunks:
            out += rs.push(data)
        return out

    # -- the payload step ---------------------------------------------- #
    def _payload_block(self, data: torch.Tensor, data_gpos: int) -> Frames:
        """Decode the symbols whose last sample lies in the block at
        data_gpos: symbols k0 .. k0+n-1, one contiguous run at pitch
        symbol_len of [carried tail, block]."""
        cfg, C = self.cfg, self.C
        sym = cfg.symbol_len
        if cfg.correct_cfo and self._eps_r != 0.0:
            # the queue is in coarse-derotated space; apply the
            # post-estimation rotation (phase reference: the region start)
            data = self._derotate(data, self._eps_r, data_gpos,
                                  self.region_start)
        ext = torch.cat([self._ptail, data], dim=-1)  # [S, sym-1+C]
        self._ptail = ext[:, -(sym - 1):]
        base = data_gpos - (sym - 1)
        pstart = self._cur_decode_start
        # owned: symbol starts g in [base, data_gpos + C - sym + 1)
        k0 = max(-((pstart - base) // sym), 0)
        k_end = min(k0 + self._nloc, cfg.pid_max,
                    -(-(data_gpos + C - sym + 1 - pstart) // sym))
        n = k_end - k0
        if n <= 0:
            return []
        rel = pstart + k0 * sym - base
        run = ext[:, rel:rel + n * sym]
        if self._use_k1:
            sig, _ = payload_fused.payload_fused_strip(
                run.real.contiguous(), run.imag.contiguous(), self.W,
                self.gain, self._table,
                np.float32(1.0 / np.sqrt(self.m_occ)), n_sym=n,
                symbol_len=sym, cp_len=cfg.cp_len, emit_sig=True)
            eq = sig.transpose(0, 1)  # [n, S, M]
        else:
            Y = rx.symbol_grid(cp_strip_mod.cp_strip(run.contiguous(), n, sym,
                                                     cfg.cp_len), cfg)
            if cfg.mode == CommMode.ALAMOUTI:
                return self._emit_alamouti(Y, k0)
            if cfg.track_channel:
                eq, s_hat = self._track(Y)
                if self._sfo_on:
                    # the SFO moment of this block's frames: statically
                    # equalized (the ramp intact) against the tracked
                    # decisions, adjacent frames; kept on the device
                    r = zf.equalize(Y, self.W, self.gain) * torch.conj(s_hat)
                    self._sfo_z = self._sfo_z + torch.sum(
                        r[1:] * torch.conj(r[:-1]), dim=(0, 1))
            else:
                eq = dispatch.equalize_dispatch(Y, self._G_occ, self.W,
                                                self.gain, cfg)
            eq = postprocess.postprocess_eq(eq, cfg)
        out = []
        for k, f in enumerate(eq.unbind(0), start=k0):
            if k not in self.frames:
                self.frames[k] = f
                out.append((k, f))
        return out

    def _track(self, Y: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """Channel tracking within a block: groups of gf frames (the last
        padded with zero frames), each equalized with the carried channel
        (ZF), decided (K4 on CUDA) and refit from its frames' decisions,
        the refit blended in; the channel is carried across blocks.
        Returns (eq, the decided points s_hat), both [n, S, m_occ]."""
        cfg = self.cfg
        n, S, m_occ = Y.shape
        gf, a = self._gf, float(np.float32(cfg.track_alpha))
        table = constellation.table_on(cfg.modulation, Y.device)
        G_occ = self._G_occ
        eqs, s_hats = [], []
        for g0 in range(0, n, gf):
            Yb = Y[g0:g0 + gf]
            nb = Yb.shape[0]
            if nb < gf:
                Yb = torch.cat([Yb, torch.zeros((gf - nb, S, m_occ),
                                                dtype=Yb.dtype,
                                                device=Yb.device)])
            W, gain = zf.invert(G_occ, cfg.invert_to_unity)
            eq = zf.equalize(Yb, W, gain)
            s_hat = table[constellation.demodulate(eq, cfg.modulation).long()]
            if nb < gf:  # the padding frames take no part in the refit
                s_hat[nb:].zero_()
            G_new = tracking.ls_refit(Yb, s_hat)
            G_occ = ((1.0 - a) * G_occ + a * G_new).to(torch.complex64)
            eqs.append(eq[:nb])
            s_hats.append(s_hat[:nb])
        self._G_occ = G_occ
        self.G = (G_occ if G_occ.shape[0] == cfg.M else self.G.index_copy(
            0, rx._occupied_on(cfg, Y.device), G_occ))
        return torch.cat(eqs), torch.cat(s_hats)

    def _emit_alamouti(self, Y: torch.Tensor, k0: int) -> Frames:
        """Keep each raw frame until its pair's mate arrives, then combine
        the pair and postprocess it (on the device)."""
        cfg = self.cfg
        out = []
        for i in range(Y.shape[0]):
            k = k0 + i
            if k in self.frames or k in self._pend:
                continue
            self._pend[k] = Y[i]
            if k ^ 1 in self._pend:
                k_lo = min(k, k ^ 1)
                pair = torch.stack([self._pend.pop(k_lo),
                                    self._pend.pop(k_lo + 1)])
                eq = torch.zeros_like(pair)
                eq[:, 0, :] = alamouti.combine_pairs(pair, self._G_occ)
                eq = postprocess.postprocess_eq(eq, cfg)
                for d in (0, 1):
                    self.frames[k_lo + d] = eq[d]
                    out.append((k_lo + d, eq[d]))
        return out

    def finalize(self) -> Frames:
        """Replay a front-end warm-up the stream ended in, flush the live
        SFO resampler's lookahead, then the queued
        payload with zero padding (what the offline decode's zero-extended
        window holds)."""
        out: Frames = []
        if self._fe_on and self._fe_dc is None and self._fe_buf:
            # the stream ended inside the warm-up: estimate on what came
            out += self._fe_start()
        if self._resampler is not None:
            for c in self._resampler.flush():
                out += self._push_inner(c)
        if self.phase != "payload" or self._q_count == 0:
            return out
        pad = self.C - (self._q_count % self.C)
        if pad != self.C:
            self._enqueue(self._zeros(pad), self._q_gpos + self._q_count)
        return out + self._drain()

    # ------------------------------------------------------------------ #
    def _assemble(self, frames: Dict[int, torch.Tensor]):
        """(rx_sig [S, pid_max*M_occ] complex64, rx_data int32 of it, K4
        on CUDA), zeros for frames not seen, on the device."""
        cfg = self.cfg
        rx_sig = torch.zeros((self.S, cfg.pid_max, self.m_occ),
                             dtype=torch.complex64, device=self.device)
        if frames:
            ks = sorted(frames)
            rx_sig.index_copy_(
                1, torch.as_tensor(ks, device=self.device),
                torch.stack([frames[k] for k in ks], dim=1))
        rx_sig = rx_sig.reshape(self.S, -1)
        return rx_sig, constellation.demodulate(rx_sig, cfg.modulation)

    def result(self):
        """(rx_sig, rx_data) of the FIRST burst (the reference's one burst
        per run): the recorded burst when one completed, else the frames
        of the burst in progress."""
        return self._assemble(self.bursts[0].frames if self.bursts
                              else self.frames)

    def burst_results(self):
        """Every burst so far as (sync_index, rx_sig, rx_data): completed
        bursts first, then the burst in progress if it emitted frames."""
        out = [(b.sync_index, *self._assemble(b.frames)) for b in self.bursts]
        if self.frames and self._cur_sync_index is not None:
            out.append((int(self._cur_sync_index),
                        *self._assemble(self.frames)))
        return out


def decode_stream(capture, cfg: ModemConfig, chunk_size: int = 1 << 16, *,
                  device) -> StreamingDecoder:
    """Run a StreamingDecoder on ``device`` over a whole capture [S, T]
    (moved to the device once), the last chunk padded with zeros, one
    ``push`` a chunk.  Returns the decoder (call ``finalize`` to flush)."""
    dec = StreamingDecoder(cfg, device=device, chunk_size=chunk_size)
    x = dec._to_device(capture)
    C = dec.C
    nc = -(-x.shape[-1] // C)
    x = F.pad(x, (0, nc * C - x.shape[-1]))
    for i in range(nc):
        dec.push(x[:, i * C:(i + 1) * C])
    return dec
