"""The modem's constant tables, written out again for the benchmark.

A frozen copy of the testbed's conventions as the program states them
(RUB_MIMO mimo/config.h:70-75, framing.cc:949-1262, liquid-dsp's
m-sequences): the S0 and S1 preambles on an all-carriers allocation,
and the constellations.  Both the generator (``reference.tx``) and the
plain receiver (``reference.rx``) take their tables from here, never
from the program, so a table the program gets wrong shows as a wrong
answer.

A configuration is a plain dict: the ``modem`` object of a file in
``portbench/configs/``.
"""

from __future__ import annotations

import functools
import json

import numpy as np

BITS = {"bpsk": 1, "qpsk": 2, "qam16": 4, "arb32opt": 5, "qam64": 6,
        "qam256": 8}


class Modem:
    """The numbers of one configuration that the generator and the
    receiver need, derived from its ``modem`` dict (hashable: the tables
    are cached by it)."""

    def __init__(self, modem: dict):
        self.doc = dict(modem)
        self.key = json.dumps(self.doc, sort_keys=True)
        self.M = int(modem["num_subcarriers"])
        self.cp = int(modem["cp_len"])
        self.S = int(modem["num_streams"])
        self.codes = int(modem["num_access_codes"])
        self.n_sym = int(modem["pid_max"])
        self.modulation = modem["modulation"]
        self.bits = BITS[self.modulation]
        self.threshold = float(modem.get("plateau_threshold", 0.95))
        self.gain = float(modem.get("baseband_gain", 0.25))
        self.detector = modem.get("detector", "zf")
        self.sym = self.M + self.cp
        self.n_seq = 1 + self.codes * self.S
        self.frame_len = self.n_seq * self.sym + self.n_sym * self.sym
        if modem.get("mode", "rx_zf") != "rx_zf":
            raise ValueError("the plain receiver takes the RX_ZF mode only")
        if self.detector != "zf" or not modem.get("use_all_carriers", True):
            raise ValueError("the plain receiver takes ZF on every carrier "
                             "only")
        if modem.get("bit_exact", True) or modem.get(
                "timing_mode", "joint") != "joint":
            raise ValueError("the plain receiver takes bit_exact=False with "
                             "joint timing only")
        for off in ("correct_cfo", "sync_fallback", "smooth_channel",
                    "track_phase", "track_channel", "s1_qpsk",
                    "same_signal_on_all_tx", "normalize_rx_scale",
                    "invert_to_unity", "mmse_auto_noise"):
            if modem.get(off, False):
                raise ValueError(f"the plain receiver does not take {off}")
        if modem.get("sync_quorum") is not None:
            raise ValueError("the plain receiver takes the all-streams "
                             "plateau rule only")

    def __hash__(self):
        return hash(self.key)

    def __eq__(self, other):
        return isinstance(other, Modem) and other.key == self.key

    @property
    def occupied(self) -> np.ndarray:
        return occupied(self.M)

    @property
    def m_occ(self) -> int:
        return int(self.occupied.size)


# ------------------------------------------------------------ m-sequences
class MSequence:
    """liquid-dsp's Galois m-sequence: state v = a, taps g >> 1; each bit
    is the parity of v & taps, shifted in at the bottom."""

    def __init__(self, m: int, g: int, a: int = 1):
        self.taps = g >> 1
        self.mask = (1 << m) - 1
        self.v = a

    def bits(self, n: int) -> np.ndarray:
        out = np.empty(n, dtype=np.uint8)
        v, g, mask = self.v, self.taps, self.mask
        for i in range(n):
            b = bin(v & g).count("1") & 1
            v = ((v << 1) | b) & mask
            out[i] = b
        self.v = v
        return out


def stream_polys(modem: dict, S: int):
    """The S access-code polynomials (mimo/config.h:74-75 has two)."""
    polys = list(modem.get("lfsr_large_polys", (0o20033, 0o20047)))
    if S > len(polys):
        raise ValueError(f"{S} streams need {S} access-code polynomials")
    return polys[:S]


# ------------------------------------------------------------- allocation
@functools.lru_cache(maxsize=None)
def occupied(M: int) -> np.ndarray:
    """The occupied carriers: every one (use_all_carriers, framing.cc
    :949-954; the guard-band allocation is not taken)."""
    return np.arange(M)


# -------------------------------------------------------------- preambles
@functools.lru_cache(maxsize=16)
def preambles(md: Modem):
    """(S0 [M], S1 [S, codes, M]) frequency-domain preambles (complex128)
    and their time-domain forms: s0 = M ifft(S0) / sqrt(M_S0), s1 = M
    ifft(S1) / sqrt(M); with the unnormalized M ifft forms (the matched
    filter's templates).  S0 takes one m-sequence bit per carrier and is
    +-1 on even occupied ones (framing.cc:1053-1111); each access code
    one bit per carrier, +-1 on every occupied one (framing.cc:1214-1262)."""
    occ = np.zeros(md.M, dtype=bool)
    occ[md.occupied] = True
    doc = md.doc
    ms = MSequence(int(doc.get("lfsr_small_length", 12)),
                   int(doc.get("lfsr_small_poly", 0o10123)), 1)
    bits = ms.bits(md.M)
    S0 = np.zeros(md.M, dtype=np.complex128)
    active = occ & (np.arange(md.M) % 2 == 0)
    S0[active] = np.where(bits[active] != 0, 1.0, -1.0)
    S1 = np.zeros((md.S, md.codes, md.M), dtype=np.complex128)
    for s, g in enumerate(stream_polys(doc, md.S)):
        ms = MSequence(int(doc.get("lfsr_large_length", 13)), g, 1)
        for j in range(md.codes):
            b = ms.bits(md.M)
            S1[s, j, occ] = np.where(b[occ] != 0, 1.0, -1.0)
    s0_un = np.fft.ifft(S0) * md.M
    s1_un = np.fft.ifft(S1, axis=-1) * md.M
    return {"S0": S0, "S1": S1,
            "s0": (s0_un / np.sqrt(active.sum())).astype(np.complex64),
            "s1": (s1_un / np.sqrt(md.M)).astype(np.complex64),
            "s0_un": s0_un, "s1_un": s1_un}


# --------------------------------------------------------- constellations
def _square_qam(bits: int) -> np.ndarray:
    """Gray-coded square QAM, unit mean energy; symbol = I bits | Q bits."""
    side = 1 << (bits // 2)
    level = np.empty(side, dtype=np.int64)
    for lv in range(side):
        level[lv ^ (lv >> 1)] = lv
    pts = np.empty(1 << bits, dtype=np.complex128)
    for k in range(1 << bits):
        i = level[k >> (bits // 2)]
        q = level[k & (side - 1)]
        pts[k] = (2 * i - side + 1) + 1j * (2 * q - side + 1)
    pts /= np.sqrt(np.mean(np.abs(pts) ** 2))
    return pts.astype(np.complex64)


def _arb32opt() -> np.ndarray:
    """The 32 triangular-lattice points of least energy about their own
    centroid, recentred, unit mean energy, in raster order (the program's
    built-in ARB32OPT layout)."""
    pts = np.array([(a + 0.5 * b) + 1j * (np.sqrt(3) / 2.0) * b
                    for a in range(-8, 9) for b in range(-8, 9)])
    sel = pts[np.argsort(np.abs(pts))[:32]]
    for _ in range(50):
        new = pts[np.argsort(np.abs(pts - sel.mean()))[:32]]
        if np.array_equal(np.sort(new.view(float)), np.sort(sel.view(float))):
            break
        sel = new
    sel = sel - sel.mean()
    sel /= np.sqrt(np.mean(np.abs(sel) ** 2))
    order = np.lexsort((np.round(sel.real, 9), np.round(sel.imag, 9)))
    return sel[order].astype(np.complex64)


@functools.lru_cache(maxsize=None)
def points(modulation: str) -> np.ndarray:
    """The modulation's points (complex64), index = symbol value."""
    if modulation == "bpsk":
        return np.array([-1.0, 1.0], dtype=np.complex64)
    if modulation == "arb32opt":
        return _arb32opt()
    return _square_qam(BITS[modulation])
