"""S0 (Schmidl&Cox short) and S1 (access-code) preamble tables.

Port of rub_mimo_tpu/ofdm/preamble.py (numpy, identical tables):

  - S0 (framing.cc:1053-1111): BPSK from one LFSR bit per subcarrier on
    EVEN occupied subcarriers only, unnormalized inverse FFT scaled by
    1/sqrt(M_S0).
  - S1 (framing.cc:1214-1262): per access code one LFSR bit per
    subcarrier, BPSK on every occupied subcarrier, inverse FFT scaled by
    1/sqrt(M); the compiled-out QPSK variant (framing.cc:1160-1212) with
    its quirks when cfg.s1_qpsk.

FFTW_BACKWARD is the unnormalized inverse DFT, i.e. M * numpy ifft.
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np

from rub_mimo_tpu.config import ModemConfig
from rub_mimo_tpu_torch.ofdm import sctype
from rub_mimo_tpu_torch.ofdm.constellation import QPSK_REFERENCE_TABLE
from rub_mimo_tpu_torch.ofdm.lfsr import MSequence, lfsr_polys_for_streams


def ifft_fftw(X: np.ndarray, axis: int = -1) -> np.ndarray:
    """FFTW_BACKWARD: unnormalized inverse DFT (= M * numpy ifft)."""
    return np.fft.ifft(X, axis=axis) * X.shape[axis]


@dataclasses.dataclass(frozen=True)
class PreambleTables:
    """S0 [M] / S1 [streams, codes, M] frequency-domain symbols, their
    normalized time-domain forms s0 / s1, and the unnormalized inverse
    FFTs (the matched-filter templates); all complex64."""

    S0: np.ndarray
    s0: np.ndarray
    S1: np.ndarray
    s1: np.ndarray
    s0_unnormalized: np.ndarray
    s1_unnormalized: np.ndarray
    M_S0: int


def init_S0(p: np.ndarray, ms: MSequence):
    """S0 short-sync symbol: one LFSR bit consumed for EVERY subcarrier;
    only even occupied subcarriers carry +/-1."""
    M = len(p)
    bits = ms.generate_bits(M)
    S0 = np.zeros(M, dtype=np.complex64)
    even = (np.arange(M) % 2) == 0
    active = (p != sctype.SCTYPE_NULL) & even
    S0[active] = np.where(bits[active] != 0, 1.0, -1.0)
    M_S0 = int(active.sum())
    if M_S0 == 0:
        raise ValueError("ofdmframe_init_S0: no subcarriers enabled")
    s0_unnorm = ifft_fftw(S0.astype(np.complex128))
    s0 = (s0_unnorm / np.sqrt(M_S0)).astype(np.complex64)
    return S0, s0, s0_unnorm.astype(np.complex64), M_S0


def init_S1(p: np.ndarray, num_access_codes: int, ms: MSequence):
    """S1 access codes for one TX stream: BPSK on occupied subcarriers,
    time domain scaled by 1/sqrt(M)."""
    M = len(p)
    occupied = p != sctype.SCTYPE_NULL
    S1 = np.zeros((num_access_codes, M), dtype=np.complex64)
    for j in range(num_access_codes):
        bits = ms.generate_bits(M)
        S1[j, occupied] = np.where(bits[occupied] != 0, 1.0, -1.0)
    s1_unnorm = ifft_fftw(S1.astype(np.complex128), axis=-1)
    s1 = (s1_unnorm / np.sqrt(M)).astype(np.complex64)
    return S1, s1, s1_unnorm.astype(np.complex64)


def init_S1_qpsk(p: np.ndarray, num_access_codes: int, ms: MSequence):
    """The MAKE_S1_QPSK variant, quirks kept: two LFSR bits per subcarrier
    masked with the reference's ``& 0x11`` (framing.cc:1188), and the
    1/sqrt(M_S1) normalization (framing.cc:1204)."""
    M = len(p)
    occupied = p != sctype.SCTYPE_NULL
    S1 = np.zeros((num_access_codes, M), dtype=np.complex64)
    m_s1 = int(occupied.sum())
    for j in range(num_access_codes):
        for i in range(M):
            s = ms.generate_symbol(2) & 0x11  # verbatim reference mask
            if occupied[i]:
                S1[j, i] = QPSK_REFERENCE_TABLE[s]
    s1_unnorm = ifft_fftw(S1.astype(np.complex128), axis=-1)
    s1 = (s1_unnorm / np.sqrt(m_s1)).astype(np.complex64)
    return S1, s1, s1_unnorm.astype(np.complex64)


@functools.lru_cache(maxsize=16)
def tables(cfg: ModemConfig) -> PreambleTables:
    """All deterministic preamble constants for a config (cached)."""
    p = sctype.allocation(cfg)
    S0, s0, s0_un, M_S0 = init_S0(
        p, MSequence(cfg.lfsr_small_length, cfg.lfsr_small_poly, 1))
    polys = lfsr_polys_for_streams(cfg)
    s1_builder = init_S1_qpsk if cfg.s1_qpsk else init_S1
    built = [
        s1_builder(p, cfg.num_access_codes,
                   MSequence(cfg.lfsr_large_length, polys[stream], 1))
        for stream in range(cfg.num_streams)
    ]
    return PreambleTables(
        S0=S0,
        s0=s0,
        S1=np.stack([b[0] for b in built]),
        s1=np.stack([b[1] for b in built]),
        s0_unnormalized=s0_un,
        s1_unnormalized=np.stack([b[2] for b in built]),
        M_S0=M_S0,
    )
