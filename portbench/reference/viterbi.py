"""A plain soft-decision Viterbi decoder of the K = 7 (171, 133) code.

A codeword of more than WHOLE_UP_TO steps is cut into windows of
WINDOW steps, each decoded with MARGIN steps of context on either side
from a uniform prior, traced back from its best state, and its interior
kept; a shorter one is decoded in one window, the exact
maximum-likelihood path.  All windows of all codewords run as one batch,
step by step on tensors.  These are the sizes at which the receiver
under test states that it decodes (its serving mode: windows of 4096
steps with 128 of margin, one scan up to four windows): where survivor
paths have not merged within a margin, as in a capture whose decode
fails, a truncated traceback's decisions depend on where the windows
fall, so the reference cuts where the receiver does.  The path metric
is the correlation sum_t (1 - 2 a_t) l_a + (1 - 2 b_t) l_b of the coded
bits (a_t, b_t) with the LLR pairs (positive -> bit 0); the encoder
starts in state 0 and its zero tail ends it there, so the pairs before
the codeword and after it are padded with certain zeros.

With the bits comes each window's tie margin: the least metric gap by
which its traced path beat another, over every add-compare-select on
that path from the interior's first step on and the choice of the state
the traceback starts from.  A decoder whose path metrics all lie within
half that gap of these (rounding) makes each of those choices alike and
traces the same interior; where the margin is smaller, the bits are not
determined at that rounding.
"""

from __future__ import annotations

import torch

from portbench.reference.tx import K, POLYS

WINDOW, MARGIN = 4096, 128
WHOLE_UP_TO = 4 * WINDOW  # steps decoded in one window
N_STATES = 1 << (K - 1)
PAD = 1e4  # an LLR pair "certainly 0"


def _tables(device):
    """For each new state n and predecessor choice j: the predecessor
    ((n << 1) & 63) | j and the signs (1 - 2 a, 1 - 2 b) of the coded
    bits of the register (u << 6) | predecessor, u = n >> 5."""
    n = torch.arange(N_STATES, device=device)
    pred = torch.stack([((n << 1) & (N_STATES - 1)) | j for j in (0, 1)], 1)
    reg = ((n >> (K - 2)) << (K - 1))[:, None] | pred
    signs = []
    for g in POLYS:
        par = torch.zeros_like(reg)
        for b in range(K):
            par ^= (reg >> b) & (g >> b) & 1
        signs.append(1.0 - 2.0 * par)
    return pred, torch.stack(signs, -1)  # [64, 2], [64, 2(j), 2(bit)]


def decode(pairs: torch.Tensor) -> tuple:
    """(decoded input bits [B, T] int32, each bit's window's tie margin
    [B, T]) of LLR pairs [B, T, 2]."""
    B, T, _ = pairs.shape
    dev, dt = pairs.device, pairs.dtype
    W = WINDOW if T > WHOLE_UP_TO else T
    nW = -(-T // W)
    span = W + 2 * MARGIN
    padded = torch.full((B, nW * W + 2 * MARGIN, 2), PAD, dtype=dt,
                        device=dev)
    padded[:, MARGIN:MARGIN + T] = pairs
    rows = padded.unfold(1, span, W).permute(0, 1, 3, 2)
    rows = rows.reshape(B * nW, span, 2)
    R = rows.shape[0]
    pred, signs = _tables(dev)
    signs = signs.to(dt)
    pm = torch.zeros((R, N_STATES), dtype=dt, device=dev)
    shift = torch.arange(N_STATES, device=dev)
    decisions = torch.empty((span, R), dtype=torch.int64, device=dev)
    # the choices' gaps, kept to 3 digits: they are held against a band
    gaps = torch.empty((span, R, N_STATES), dtype=torch.bfloat16,
                       device=dev)
    for t in range(span):
        bm = torch.einsum("jkb,rb->rjk", signs.transpose(0, 1), rows[:, t])
        cand = pm[:, pred] + bm.permute(0, 2, 1)   # [R, 64, 2]
        best, j = cand.max(dim=-1)                  # ties keep j = 0
        decisions[t] = (j << shift).sum(-1)
        gaps[t] = (cand[..., 0] - cand[..., 1]).abs()
        pm = best - best.max(dim=-1, keepdim=True).values
    top2 = pm.topk(2, dim=-1).values
    tie = top2[:, 0] - top2[:, 1]  # the traceback's starting state
    state = torch.argmax(pm, dim=-1)
    bits = torch.empty((R, span), dtype=torch.int32, device=dev)
    for t in range(span - 1, -1, -1):
        bits[:, t] = (state >> (K - 2)).to(torch.int32)
        if t >= MARGIN:  # a choice before the interior moves no bit of it
            tie = torch.minimum(tie, gaps[t].gather(1, state[:, None])[:, 0]
                                .to(dt))
        j = (decisions[t] >> state) & 1
        state = ((state << 1) & (N_STATES - 1)) | j
    inner = bits[:, MARGIN:MARGIN + W].reshape(B, nW * W)
    ties = tie.reshape(B, nW, 1).expand(B, nW, W).reshape(B, nW * W)
    return inner[:, :T], ties[:, :T]
