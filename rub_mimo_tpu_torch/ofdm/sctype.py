"""Subcarrier allocation: classify each subcarrier as null/pilot/data.

Port of rub_mimo_tpu/ofdm/sctype.py (numpy, identical tables), plus
``allocation(cfg)`` and ``m_occupied(cfg)``: the port never calls
``ModemConfig.subcarrier_allocation()`` / ``.M_occupied``, which import
the JAX package's ofdm modules (and with them jax).
"""

from __future__ import annotations

import functools
from typing import Tuple

import numpy as np

# Subcarrier type codes (liquid-dsp OFDMFRAME_SCTYPE_*)
SCTYPE_NULL = 0
SCTYPE_PILOT = 1
SCTYPE_DATA = 2


@functools.lru_cache(maxsize=32)
def init_default_sctype(
    M: int,
    use_all_carriers: bool = True,
    add_null_carriers: bool = True,
) -> np.ndarray:
    """Default subcarrier allocation vector of length M (read-only).

    use_all_carriers=True  -> every subcarrier is data (framing.cc:949-954)
    use_all_carriers=False -> guard band of M/10 nulls around DC-mirrored
        band edges, every 8th (or 4th for small M) occupied carrier a pilot
        (framing.cc:956-997)
    """
    p = np.zeros(M, dtype=np.uint8)
    if use_all_carriers:
        p[:] = SCTYPE_DATA
        p.setflags(write=False)
        return p

    M2 = M // 2
    G = max(M // 10, 2) if add_null_carriers else 0
    P = 8 if M > 34 else 4
    P2 = P // 2
    for i in range(1, M2 - G):
        sc = SCTYPE_PILOT if ((i + P2) % P) == 0 else SCTYPE_DATA
        p[i] = sc          # upper band
        p[M - i] = sc      # lower band (mirrored)
    p.setflags(write=False)
    return p


def validate_sctype(p: np.ndarray) -> Tuple[int, int, int]:
    """Count (M_null, M_pilot, M_data); raises on invalid codes
    (ofdmframe_validate_sctype, framing.cc:1000-1030)."""
    counts = np.bincount(p, minlength=3)
    if counts[3:].any():
        raise ValueError("invalid subcarrier type in allocation")
    return (int(counts[SCTYPE_NULL]), int(counts[SCTYPE_PILOT]),
            int(counts[SCTYPE_DATA]))


def occupied_mask(p: np.ndarray) -> np.ndarray:
    """Boolean mask of occupied (pilot or data) subcarriers."""
    return p != SCTYPE_NULL


def occupied_indices(p: np.ndarray) -> np.ndarray:
    """Indices of occupied subcarriers, in increasing subcarrier order
    (framing.cc:217-222, 524-530, 569-578)."""
    return np.nonzero(p != SCTYPE_NULL)[0].astype(np.int32)


def format_sctype(p: np.ndarray) -> str:
    """The allocation as the reference prints it (framing.cc:1032-1051):
    DC-centred, '.' null / '|' pilot / '+' data."""
    M = len(p)
    chars = {SCTYPE_NULL: ".", SCTYPE_PILOT: "|", SCTYPE_DATA: "+"}
    rotated = (int(p[(i + M // 2) % M]) for i in range(M))
    return "[" + "".join(chars[c] for c in rotated) + "]"


def allocation(cfg) -> np.ndarray:
    """The config's allocation vector (ModemConfig.subcarrier_allocation)."""
    return init_default_sctype(
        cfg.num_subcarriers,
        use_all_carriers=cfg.use_all_carriers,
        add_null_carriers=cfg.add_null_carriers,
    )


def m_occupied(cfg) -> int:
    """Number of occupied subcarriers (ModemConfig.M_occupied)."""
    _, m_pilot, m_data = validate_sctype(allocation(cfg))
    return m_pilot + m_data
