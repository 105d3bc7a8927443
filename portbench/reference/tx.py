"""The benchmark's generator: TX frame, channel and convolutional encoder.

A frozen plain-torch copy of what the program's own simulator does
(rub_mimo_tpu_torch io/simulator.py, ofdm/framegen.py and ofdm/fec.py's
encoder), kept here so that the traffic cannot change when the program
does.  ``tests/test_portbench_generator.py`` holds it equal to the
program's ``simulate_capture`` on the same payload, channel and noise
seed.

TX (RUB_MIMO framing.cc:79-266, main.cc:1027-1112): the sync words (CP
+ S0 on stream 0, then the access codes in TDMA slots), then pid_max
OFDM symbols of the payload (points on the occupied carriers, M-point
inverse FFT scaled by M / sqrt(M_occ), CP prepended), all times the
baseband gain.  Channel: a flat S x S mix, delay and trailing zeros,
AWGN at the SNR against the mean TX power.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from portbench.reference.tables import Modem, points, preambles

POLYS = (0o171, 0o133)  # IEEE 802.11a-1999 17.3.5.5, MSB = newest bit
K = 7
TAIL = K - 1


def sync_words(md: Modem, device) -> torch.Tensor:
    """[S, n_seq * sym] complex64: CP + S0 on stream 0 in slot 0, access
    code (code, stream) on that stream in slot 1 + code * S + stream."""
    pre = preambles(md)
    out = np.zeros((md.S, md.n_seq * md.sym), dtype=np.complex64)

    def place(stream, slot, x):
        base = slot * md.sym
        out[stream, base:base + md.cp] = x[-md.cp:]
        out[stream, base + md.cp:base + md.sym] = x

    place(0, 0, pre["s0"])
    for code in range(md.codes):
        for s in range(md.S):
            place(s, 1 + code * md.S + s, pre["s1"][s, code])
    return torch.as_tensor(out, device=device)


def transmit(md: Modem, tx_data: torch.Tensor) -> torch.Tensor:
    """TX baseband [S, frame_len] complex64 of integer symbols tx_data
    [S, pid_max * M_occ] on tx_data's device."""
    dev = tx_data.device
    occ = torch.as_tensor(md.occupied, device=dev).long()
    table = torch.as_tensor(points(md.modulation), device=dev)
    sig = table[tx_data.long()].reshape(md.S, md.n_sym, md.m_occ)
    X = torch.zeros((md.S, md.n_sym, md.M), dtype=torch.complex64,
                    device=dev)
    X[:, :, occ] = sig
    x = torch.fft.ifft(X, dim=-1) * (md.M / np.sqrt(md.m_occ))
    payload = torch.cat([x[:, :, md.M - md.cp:], x], dim=-1)
    out = torch.cat([sync_words(md, dev),
                     payload.reshape(md.S, md.n_sym * md.sym)], dim=-1)
    return (out * md.gain).to(torch.complex64)


def draw_channel(rng: np.random.Generator, S: int,
                 dominance: float = 2.0) -> np.ndarray:
    """A flat channel h [S(rx), S(tx), 1] complex64: unit complex normal
    entries, the diagonal times ``dominance``."""
    h = (rng.standard_normal((S, S, 1))
         + 1j * rng.standard_normal((S, S, 1))) / np.sqrt(2.0)
    for i in range(S):
        h[i, i, 0] *= dominance
    return h.astype(np.complex64)


def apply_channel(tx: torch.Tensor, h: np.ndarray, delay: int, trailing: int,
                  snr_db: float, gen: torch.Generator) -> torch.Tensor:
    """rx [S, delay + L + trailing] complex64 on tx's device: tx mixed by
    the flat h, ``delay`` zeros before and ``trailing`` after, plus AWGN
    at snr_db against the mean TX power (two draws of ``gen``: real,
    then imaginary parts)."""
    h = torch.as_tensor(h, device=tx.device)
    y = torch.einsum("rt,tn->rn", h[..., 0], tx)
    y = F.pad(y, (delay, trailing))
    sig_power = torch.mean(tx.real ** 2 + tx.imag ** 2)
    noise_var = sig_power * 10.0 ** (-snr_db / 10.0)
    nr = torch.randn(y.shape, generator=gen, device=tx.device)
    ni = torch.randn(y.shape, generator=gen, device=tx.device)
    noise = torch.sqrt(noise_var / 2.0) * torch.complex(nr, ni)
    return (y + noise).to(torch.complex64)


# ------------------------------------------------------------------ FEC
def message_bits(md: Modem) -> int:
    """Message bits a stream at rate 1/2: half the payload's bits, less
    the zero tail."""
    return md.n_sym * md.m_occ * md.bits // 2 - TAIL


def interleave_stride(n: int, spread: int = 127) -> int:
    """The smallest stride >= spread coprime to n."""
    s = spread
    while np.gcd(s, n) != 1:
        s += 1
    return s


def conv_encode(bits: torch.Tensor) -> torch.Tensor:
    """Rate-1/2 K = 7 code, zero-tail terminated: [..., n] bits ->
    [..., 2 (n + 6)] int32, A_0 B_0 A_1 B_1 ..., coded bit g at step t
    the parity of the 7 newest input bits under POLYS[g]."""
    bits = bits.to(torch.int32)
    z = torch.zeros(bits.shape[:-1] + (TAIL,), dtype=torch.int32,
                    device=bits.device)
    padded = torch.cat([z, bits, z], dim=-1)
    total = bits.shape[-1] + TAIL
    out = []
    for g in POLYS:
        acc = torch.zeros(bits.shape[:-1] + (total,), dtype=torch.int32,
                          device=bits.device)
        for k in range(K):  # tap k: the bit k steps back
            if (g >> (K - 1 - k)) & 1:
                acc ^= padded[..., K - 1 - k:K - 1 - k + total]
        out.append(acc)
    return torch.stack(out, dim=-1).reshape(*bits.shape[:-1], 2 * total)


def encode(md: Modem, msg: torch.Tensor) -> torch.Tensor:
    """Message bits [S, n_msg] -> payload symbols [S, pid_max * M_occ]
    int32: encoded, zero-padded to the payload's bits, interleaved by the
    stride permutation out[i] = in[(i * s) % n] (spread 127) and packed
    MSB first."""
    n = md.n_sym * md.m_occ * md.bits
    coded = F.pad(conv_encode(msg), (0, n - 2 * (msg.shape[-1] + TAIL)))
    s = interleave_stride(n)
    perm = torch.arange(n, dtype=torch.int64, device=msg.device) * s % n
    coded = coded.index_select(-1, perm)
    w = 1 << torch.arange(md.bits - 1, -1, -1, dtype=torch.int32,
                          device=msg.device)
    return (coded.reshape(md.S, -1, md.bits) * w).sum(-1).to(torch.int32)
