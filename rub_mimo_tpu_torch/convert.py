"""Carry the JAX package's state into the port's tensors.

The modem has no learned weights; what the two packages share is their
per-config constants and the per-capture channel state a decode derives.
``from_jax_state`` takes that state as numpy arrays (the JAX side hands
it over with ``np.asarray``; this module imports no jax) and returns it
as tensors of the port's dtypes on ``device``, so the port's later stages
can run on the JAX package's earlier results — e.g. the payload tail on
JAX's W and gain, isolated from estimation rounding.
"""

from __future__ import annotations

import numpy as np
import torch

# key -> (numpy kind, torch dtype, rank)
STATE_KEYS = {
    # per-config constants
    "table": ("c", torch.complex64, 1),      # constellation points [K]
    "S1": ("c", torch.complex64, 3),         # [streams, codes, M]
    "templates": ("c", torch.complex64, 2),  # [1 + codes*streams, M]
    # per-capture channel state (a JAX DecodeResult's fields)
    "G": ("c", torch.complex64, 3),               # [M, rx, tx]
    "W": ("c", torch.complex64, 3),               # [M_occ, out, rx]
    "normalize_gain": ("f", torch.float32, 1),   # [M_occ]
    "ac_index": ("i", torch.int64, 2),            # [streams, codes*streams]
    "decode_start": ("i", torch.int64, 0),        # scalar
}


def from_jax_state(arrays: dict, device) -> dict:
    """numpy arrays keyed as in STATE_KEYS -> tensors on ``device``.

    Raises on an unknown key, a value of the wrong kind (complex, float,
    integer) or rank, or W / normalize_gain / G that disagree in size."""
    out = {}
    for key, value in arrays.items():
        if key not in STATE_KEYS:
            raise KeyError(f"unknown state key {key!r}; expected one of "
                           f"{sorted(STATE_KEYS)}")
        kind, dtype, rank = STATE_KEYS[key]
        a = np.asarray(value)
        if a.dtype.kind != kind or a.ndim != rank:
            raise ValueError(f"{key}: expected a rank-{rank} array of kind "
                             f"{kind!r}, got {a.dtype} with shape {a.shape}")
        out[key] = torch.as_tensor(np.array(a), device=device).to(dtype)
    if "W" in out and "normalize_gain" in out:
        if out["W"].shape[0] != out["normalize_gain"].shape[0]:
            raise ValueError("W and normalize_gain cover different "
                             "subcarrier counts")
    if "G" in out and "W" in out and out["G"].shape[1:] != out["W"].shape[1:]:
        raise ValueError("G and W have different stream counts")
    return out
