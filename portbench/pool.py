"""The traffic: a pool of distinct captures made on the device from the
seed.

A traffic file (``traffic/<name>.json``) gives the pool's size, the
capture length, the range of frame delays and the SNR.  Every capture
gets its own channel (flat S x S, i.i.d. unit complex normal entries:
deep fades and ill-conditioned draws included, as over the air),
payload, noise and delay.  The delays are the same set for every seed
(the midpoints of the pool's size of equal strata of the range), in a
seeded order: the sync's work, and with it the latest captures'
latency, depends on the delay, so a seed changes only which capture has
which.  Small draws come from numpy's generator, the bulk (payload,
message bits, noise) from one ``torch.Generator`` on the device, in a
few calls a capture.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from portbench.reference import tx


class Pool(NamedTuple):
    re: torch.Tensor            # [P, S, T] float32
    im: torch.Tensor            # [P, S, T] float32
    delays: np.ndarray          # [P] int64
    msg: Optional[torch.Tensor]  # [P, S, n_msg] uint8 of a coded pool

    @property
    def views(self) -> list:
        """(re, im) [1, S, T] of each capture, as a serve call takes it."""
        return [(self.re[i:i + 1], self.im[i:i + 1])
                for i in range(self.re.shape[0])]

    def capture(self, i: int) -> torch.Tensor:
        """Capture i as [S, T] complex64."""
        return torch.complex(self.re[i], self.im[i])


def delays(rng: np.random.Generator, lo: int, hi: int, n: int) -> np.ndarray:
    """n delays in [lo, hi]: the midpoints of n equal strata, in a random
    order."""
    d = lo + (np.arange(n) + 0.5) * ((hi - lo) / n)
    return d.astype(np.int64)[rng.permutation(n)]


def check(md, traffic: dict) -> None:
    lo, hi = traffic["delay"]
    if not 0 <= lo <= hi or hi + md.frame_len > traffic["capture_samples"]:
        raise ValueError(f"frames of {md.frame_len} samples at delays "
                         f"{lo}-{hi} do not fit captures of "
                         f"{traffic['capture_samples']}")


def make(md, traffic: dict, seed: int, device,
         coded: bool = False) -> Pool:
    """The pool of ``traffic`` for a configuration's Modem ``md`` (its
    plain receiver's, ``Registry.receiver``)."""
    check(md, traffic)
    rng = np.random.default_rng(seed)
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    P, T = traffic["pool"], traffic["capture_samples"]
    d = delays(rng, *traffic["delay"], P)
    re = torch.empty((P, md.S, T), dtype=torch.float32, device=device)
    im = torch.empty_like(re)
    msgs = []
    for p in range(P):
        h = tx.draw_channel(rng, md.S, dominance=1.0)
        if coded:
            msg = torch.randint(0, 2, (md.S, tx.message_bits(md)),
                                generator=gen, device=device,
                                dtype=torch.int32)
            data = tx.encode(md, msg)
            msgs.append(msg.to(torch.uint8))
        else:
            data = torch.randint(0, 1 << md.bits,
                                 (md.S, md.n_sym * md.m_occ),
                                 generator=gen, device=device,
                                 dtype=torch.int32)
        y = tx.apply_channel(tx.transmit(md, data), h, int(d[p]),
                             T - md.frame_len - int(d[p]),
                             traffic["snr_db"], gen)
        re[p] = y.real
        im[p] = y.imag
    return Pool(re, im, d, torch.stack(msgs) if coded else None)
