"""The plain receiver that the program's answers are judged against.

Straightforward float64 PyTorch of the testbed's receive chain (RUB_MIMO
framing.cc:284-857), written from its description and not from the
program; it imports nothing of the program and takes nothing the
program made: its tables come from ``reference.tables``.

  sync      the Schmidl & Cox metric |corr|^2 / energy^2 of every sample
            (corr[t] = -sum_{k<M/2} conj(x[t-k-M/2]) x[t-k], energy[t] =
            1/2 sum_{k<M} |x[t-k]|^2), fired at the first sample where
            every stream has held it above the threshold for more than
            cp_len samples; sync_index = floor(mean of the run starts)
  matched   the estimation region (one symbol before sync_index, the
  filter    sync words and M more samples, zeros outside the capture),
            each template correlated over its own symbol's offsets, one
            joint argmax over the pooled energy
  LS        G[sc, rx, tx] = mean over codes of FFT(window)[sc] / S1[sc]
            / sqrt(M_occ), at each access code's offset
  detector  ZF: inv(G) per subcarrier
  payload   pid_max symbols from the last access code's peak + M, CP
            dropped, FFT / sqrt(M_occ), equalized, hard decisions by the
            nearest point (with the top-2 margin of each)
  coded     max-log LLRs, deinterleave, windowed Viterbi (reference.viterbi)

``precision="float64"`` is the reference.  ``precision="bfloat16"`` is
the control: the same chain with every stage's result rounded to
bfloat16, the step below the float32 the configurations state.
``precision="float32"`` is the same chain in float32: a second witness
of what float32 arithmetic alone does to an answer.
"""

from __future__ import annotations

import numpy as np
import torch

from portbench.reference import tx as tx_mod
from portbench.reference import viterbi
from portbench.reference.tables import Modem, points, preambles

DEMAP_BLOCK = 1 << 20  # symbols a pass of the hard and soft demaps


class Precision:
    """How the chain rounds: float64 or float32 throughout, or float32
    arithmetic with each stage's result rounded to bfloat16."""

    def __init__(self, name: str):
        if name not in ("float64", "float32", "bfloat16"):
            raise ValueError(f"unknown precision {name!r}")
        self.name = name
        self.low = name == "bfloat16"
        wide = name == "float64"
        self.real = torch.float64 if wide else torch.float32
        self.cplx = torch.complex128 if wide else torch.complex64

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        """x in this precision: a stage's result, stored."""
        if x.is_complex():
            x = x.to(self.cplx)
            if self.low:
                x = torch.complex(x.real.to(torch.bfloat16).float(),
                                  x.imag.to(torch.bfloat16).float())
            return x
        x = x.to(self.real)
        return x.to(torch.bfloat16).float() if self.low else x


def _movsum(v: torch.Tensor, w: int) -> torch.Tensor:
    """out[..., t] = sum_{k<w} v[..., t-k], zeros before 0."""
    cs = torch.cumsum(torch.nn.functional.pad(v, (1, 0)), dim=-1)
    lo = torch.nn.functional.pad(cs[..., :-w], (w, 0))[..., :cs.shape[-1]]
    return (cs - lo)[..., 1:]


def sc_metric(x: torch.Tensor, md: Modem, p: Precision) -> torch.Tensor:
    """The Schmidl & Cox metric [S, T] of a capture x [S, T]."""
    M2 = md.M // 2
    prod = torch.zeros_like(x)
    prod[:, M2:] = torch.conj(x[:, :-M2]) * x[:, M2:]
    corr = p(-_movsum(p(prod), M2))
    energy = p(0.5 * _movsum(p(x.real ** 2 + x.imag ** 2), md.M))
    return p((corr.real ** 2 + corr.imag ** 2) / (energy * energy))


def synchronize(x: torch.Tensor, md: Modem, p: Precision,
                tie_band: float = 0.0) -> dict:
    """synced, t_star (the last sample the sync reads: the fire, or the
    capture's last sample where it never fires), sync_index and
    ``near_tie``: whether a sample from
    2 cp_len before the earliest run start up to t* lies within tie_band
    of the threshold (a float32 metric may then put a run start one
    sample away)."""
    metric = sc_metric(x, md, p)
    S, T = metric.shape
    above = metric > md.threshold
    idx = torch.arange(T, device=x.device).expand(S, T)
    last_below = torch.cummax(torch.where(above, -1, idx), dim=-1).values
    run_start = last_below + 1
    fire = (above & (idx - run_start > md.cp)).all(dim=0)
    synced = bool(fire.any())
    t_star = int(torch.argmax(fire.to(torch.uint8))) if synced else T - 1
    starts = run_start[:, t_star]
    lo = max(int(starts.min()) - 2 * md.cp, 0)
    near = bool(((metric[:, lo:t_star + 1] - md.threshold).abs()
                 < tie_band).any())
    return {"synced": synced, "t_star": t_star,
            "sync_index": int(starts.sum()) // S, "near_tie": near}


def region(x: torch.Tensor, sync_index: int, md: Modem) -> torch.Tensor:
    """The estimation region [S, n_seq * sym + M], zeros outside x."""
    start = min(max(sync_index, 0), x.shape[-1]) - md.sym
    return window(x, start, md.n_seq * md.sym + md.M)


def window(x: torch.Tensor, start: int, length: int) -> torch.Tensor:
    """x[:, start : start + length], zeros where that lies outside x."""
    out = torch.zeros((x.shape[0], length), dtype=x.dtype, device=x.device)
    a, b = max(start, 0), min(start + length, x.shape[-1])
    if b > a:
        out[:, a - start:b - start] = x[:, a:b]
    return out


def matched_filter(w: torch.Tensor, md: Modem, p: Precision) -> int:
    """The joint offset i0 in [0, sym): the argmax over offsets of the
    templates' correlation energy |corr|^2 / M^2, pooled over streams
    and templates; template q (S0, then access code (code, tx) at
    1 + code * S + tx) is searched at q * sym + i."""
    pre = preambles(md)
    tmpl = [pre["s0_un"]] + [pre["s1_un"][t, c] for c in range(md.codes)
                             for t in range(md.S)]
    L = md.sym + md.M
    T = p(torch.as_tensor(np.stack(tmpl), device=w.device))
    lanes = w.unfold(-1, L, md.sym)[:, :md.n_seq]   # [S, n_seq, L]
    Wf = p(torch.fft.fft(lanes, n=L, dim=-1))
    Tf = p(torch.fft.fft(T, n=L, dim=-1))
    corr = p(torch.fft.ifft(Wf * torch.conj(Tf), dim=-1))[..., :md.sym]
    energy = p((corr.real ** 2 + corr.imag ** 2) / float(md.M) ** 2)
    return int(torch.argmax(energy.sum(dim=(0, 1))))


def estimate_channel(w: torch.Tensor, i0: int, md: Modem,
                     p: Precision) -> torch.Tensor:
    """LS channel G [M_occ, rx, tx] from the access codes at i0."""
    pre = preambles(md)
    occ = torch.as_tensor(md.occupied, device=w.device)
    S1 = torch.as_tensor(pre["S1"], device=w.device)[:, :, occ]
    G = torch.zeros((md.m_occ, md.S, md.S), dtype=p.cplx, device=w.device)
    L = w.shape[-1]
    for c in range(md.codes):
        for t in range(md.S):
            off = i0 + (1 + c * md.S + t) * md.sym
            off = min(max(off, 0), L - md.M)
            X = p(torch.fft.fft(w[:, off:off + md.M], dim=-1))[:, occ]
            G[:, :, t] += p(X / S1[t, c]).T
    return p(G / (md.codes * np.sqrt(md.m_occ)))


def detector(G: torch.Tensor, md: Modem, p: Precision) -> torch.Tensor:
    """Per-subcarrier ZF equalizer inv(G) [M_occ, out, rx]."""
    return p(torch.linalg.inv(G))


def condition(G: torch.Tensor) -> float:
    """The worst condition number of G over the subcarriers: the factor
    by which zero forcing can scale a relative error of G or of the
    samples into the equalized symbols."""
    sv = torch.linalg.svdvals(G.to(torch.complex128))
    return float((sv[:, 0] / sv[:, -1]).max())


def equalize(x: torch.Tensor, payload_start: int, Wd: torch.Tensor,
             md: Modem, p: Precision) -> torch.Tensor:
    """rx_sig [S, pid_max * M_occ]: the payload's symbols from
    payload_start, CP dropped, FFT / sqrt(M_occ), equalized."""
    occ = torch.as_tensor(md.occupied, device=x.device)
    pay = window(x, payload_start, md.n_sym * md.sym)
    sym = pay.reshape(md.S, md.n_sym, md.sym)[:, :, md.cp:]
    Y = p(torch.fft.fft(sym, dim=-1) / np.sqrt(md.m_occ))[:, :, occ]
    eq = p(torch.einsum("kor,rnk->onk", Wd, Y))
    return eq.reshape(md.S, md.n_sym * md.m_occ)


def demap(y: torch.Tensor, md: Modem) -> tuple:
    """(decisions int32, top-2 margin) of y by the nearest point: the
    score Re(y)Re(c) + Im(y)Im(c) - |c|^2/2, first maximum winning."""
    c = torch.as_tensor(points(md.modulation), device=y.device).to(y.dtype)
    half = (c.real ** 2 + c.imag ** 2) / 2
    flat = y.reshape(-1)
    dec = torch.empty(flat.shape, dtype=torch.int32, device=y.device)
    margin = torch.empty(flat.shape, dtype=y.real.dtype, device=y.device)
    for a in range(0, flat.numel(), DEMAP_BLOCK):
        v = flat[a:a + DEMAP_BLOCK, None]
        score = v.real * c.real + v.imag * c.imag - half
        top = torch.topk(score, 2, dim=-1)
        dec[a:a + DEMAP_BLOCK] = torch.argmax(score, dim=-1).to(torch.int32)
        margin[a:a + DEMAP_BLOCK] = top.values[:, 0] - top.values[:, 1]
    return dec.reshape(y.shape), margin.reshape(y.shape)


def llrs(y: torch.Tensor, md: Modem, p: Precision) -> torch.Tensor:
    """Max-log LLRs in wire order [S, N * bits] (positive -> bit 0, MSB
    first): per bit, the least |y - c|^2 over points whose bit is 1 less
    the least over points whose bit is 0."""
    c = torch.as_tensor(points(md.modulation), device=y.device).to(y.dtype)
    k = torch.arange(c.numel(), device=y.device)
    out = torch.empty((y.numel(), md.bits), dtype=y.real.dtype,
                      device=y.device)
    flat = y.reshape(-1)
    inf = torch.tensor(float("inf"), dtype=y.real.dtype, device=y.device)
    for a in range(0, flat.numel(), DEMAP_BLOCK):
        d = p((flat[a:a + DEMAP_BLOCK, None] - c).abs() ** 2)
        for b in range(md.bits):
            one = ((k >> (md.bits - 1 - b)) & 1).bool()
            out[a:a + DEMAP_BLOCK, b] = (
                torch.where(one, d, inf).amin(-1)
                - torch.where(one, inf, d).amin(-1))
    return p(out).reshape(y.shape[0], -1)


def decode_bits(y: torch.Tensor, md: Modem, p: Precision) -> tuple:
    """(message bits [L, n_msg] int32, each bit's Viterbi tie margin) of
    the equalized symbols y [L, N], a codeword a row (the streams of one
    capture or of several): LLRs, deinterleaved, then the Viterbi (rate
    1/2, zero tail)."""
    ll = llrs(y, md, p)
    n = ll.shape[-1]
    perm = (torch.arange(n, dtype=torch.int64, device=y.device)
            * tx_mod.interleave_stride(n) % n)
    de = torch.empty_like(ll)
    de[:, perm] = ll
    n_msg = tx_mod.message_bits(md)
    pairs = de[:, :2 * (n_msg + tx_mod.TAIL)].reshape(y.shape[0], -1, 2)
    bits, ties = viterbi.decode(pairs)
    return bits[:, :n_msg], ties[:, :n_msg]


def receive(x: torch.Tensor, md: Modem, precision: str = "float64", *,
            tie_band: float = 0.0, coded: bool = False) -> dict:
    """Every answer the program gives for capture x [S, T] complex64:
    synced, sync_index, payload_start (the absolute first sample of the
    payload window), G [M_occ, rx, tx], rx_sig, rx_data, the decisions'
    top-2 margins, near_tie, G's condition number ``cond`` (the worst
    subcarrier's), and with ``coded`` the message bits.  Where
    the sync never fires, only synced, t_star, sync_index and near_tie."""
    p = Precision(precision)
    x = p(x)
    out = synchronize(x, md, p, tie_band)
    if not out["synced"]:
        return out  # no frame found: nothing more to answer
    w = region(x, out["sync_index"], md)
    i0 = matched_filter(w, md, p)
    G = estimate_channel(w, i0, md, p)
    Wd = detector(G, md, p)
    region_start = min(max(out["sync_index"], 0), x.shape[-1]) - md.sym
    # the payload starts M after the last access code's peak
    start = region_start + i0 + (md.n_seq - 1) * md.sym + md.M
    sig = equalize(x, start, Wd, md, p)
    data, margin = demap(sig, md)
    out.update(payload_start=start, G=G, rx_sig=sig, rx_data=data,
               margin=margin, cond=condition(G))
    if coded:
        out["msg"] = decode_bits(sig, md, p)[0]
    return out
