"""Bit-exact liquid-dsp style m-sequence (Galois LFSR) generator.

Port of rub_mimo_tpu/ofdm/lfsr.py (numpy, identical streams).  liquid's
algorithm (msequence objects, mimo/main.cc:1268-1270):

    create(m, g, a):  state v = a;  gg = g >> 1;  mask = (1 << m) - 1
    advance():        b = parity(v & gg);  v = ((v << 1) | b) & mask;  return b
    generate_symbol(bps): fold bps advance() bits MSB-first
"""

from __future__ import annotations

import functools
from typing import List, Tuple

import numpy as np


def _parity(x: int) -> int:
    return bin(x).count("1") & 1


class MSequence:
    """liquid-dsp compatible m-sequence generator: m is the register
    length, g the generator polynomial as given to liquid (which stores
    g >> 1), a the initial state."""

    def __init__(self, m: int, g: int, a: int = 1):
        self.m = m
        self._g = g >> 1
        self._mask = (1 << m) - 1
        self.v = a

    def advance(self) -> int:
        b = _parity(self.v & self._g)
        self.v = ((self.v << 1) | b) & self._mask
        return b

    def generate_symbol(self, bps: int) -> int:
        s = 0
        for _ in range(bps):
            s = (s << 1) | self.advance()
        return s

    def generate_bits(self, n: int) -> np.ndarray:
        """The next n output bits as a uint8 array."""
        out = np.empty(n, dtype=np.uint8)
        v, g, mask = self.v, self._g, self._mask
        for i in range(n):
            b = _parity(v & g)
            v = ((v << 1) | b) & mask
            out[i] = b
        self.v = v
        return out


def sequence_period(m: int, g: int, a: int = 1) -> int:
    """Actual period of the LFSR state sequence (2^m - 1 iff primitive)."""
    ms = MSequence(m, g, a)
    start = ms.v
    limit = 1 << (m + 1)
    for i in range(1, limit):
        ms.advance()
        if ms.v == start:
            return i
    return limit


@functools.lru_cache(maxsize=8)
def find_primitive_polys(m: int, count: int,
                         skip: Tuple[int, ...] = ()) -> Tuple[int, ...]:
    """Deterministically find ``count`` degree-m primitive polynomials,
    scanning candidates in increasing numeric order."""
    found: List[int] = []
    full = (1 << m) - 1
    for g in range((1 << m) | 1, 1 << (m + 1), 2):
        if g in skip:
            continue
        if sequence_period(m, g) == full:
            found.append(g)
            if len(found) == count:
                break
    return tuple(found)


def lfsr_polys_for_streams(cfg) -> Tuple[int, ...]:
    """num_streams degree-``lfsr_large_length`` polynomials: the configured
    ones first (mimo/config.h:74-75), extended deterministically with
    further primitive polynomials for more than two streams."""
    polys = list(cfg.lfsr_large_polys[: cfg.num_streams])
    if len(polys) < cfg.num_streams:
        extra = find_primitive_polys(
            cfg.lfsr_large_length, cfg.num_streams,
            skip=tuple(cfg.lfsr_large_polys),
        )
        for g in extra:
            if g not in polys:
                polys.append(g)
            if len(polys) == cfg.num_streams:
                break
    if len(polys) < cfg.num_streams:
        raise ValueError(
            f"could not find {cfg.num_streams} primitive polynomials of "
            f"degree {cfg.lfsr_large_length}"
        )
    return tuple(polys)
