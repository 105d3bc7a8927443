"""TX frame generation: sync words + batched OFDM payload framing.

Port of rub_mimo_tpu/ofdm/framegen.py for the RX_ZF path (every stream
carries its own payload, no precoder).  Alamouti, SISO/diversity and
precoded TX are not ported yet.

Conventions (matching the reference, framing.cc:79-266):
  - IFFT is unnormalized FFTW_BACKWARD (= M * ifft), scaled by
    1/sqrt(M_occupied) (framing.cc:115,224).
  - The sync-word block is (num_access_codes*num_streams + 1) symbols:
    CP+S0 on stream 0 only, then the access codes TDMA — exactly one stream
    transmits per symbol slot (framing.cc:170-208).
"""

from __future__ import annotations

import numpy as np
import torch

from rub_mimo_tpu.config import CommMode, ModemConfig
from rub_mimo_tpu_torch.ofdm import constellation, preamble, sctype


def write_sync_words(cfg: ModemConfig) -> np.ndarray:
    """The sync-word block, [num_streams, sync_words_len] complex64.

    Stream 0 holds [CP+s0] then its TDMA access-code slots; slot
    1 + code*num_streams + stream carries (code, stream)."""
    t = preamble.tables(cfg)
    sym = cfg.symbol_len
    out = np.zeros((cfg.num_streams, cfg.sync_words_len), dtype=np.complex64)

    def place(stream: int, slot: int, x: np.ndarray) -> None:
        base = slot * sym
        out[stream, base: base + cfg.cp_len] = x[-cfg.cp_len:]
        out[stream, base + cfg.cp_len: base + sym] = x

    place(0, 0, t.s0)
    for code in range(cfg.num_access_codes):
        for stream in range(cfg.num_streams):
            place(stream, 1 + code * cfg.num_streams + stream,
                  t.s1[stream, code])
    return out


def assemble_payload(cfg: ModemConfig, payload: torch.Tensor) -> torch.Tensor:
    """OFDM symbols with CP from constellation points.

    payload: [num_streams, num_symbols, M_occupied] complex
    returns: [num_streams, num_symbols * symbol_len] complex64

    Occupied subcarriers get the payload in increasing subcarrier order,
    nulls 0; unnormalized IFFT scaled by 1/sqrt(M_occupied); the last
    cp_len samples prepended (framing.cc:210-235)."""
    occ = torch.as_tensor(sctype.occupied_indices(sctype.allocation(cfg)),
                          device=payload.device).long()
    S, n_sym, m_occ = payload.shape
    M = cfg.M
    X = torch.zeros((S, n_sym, M), dtype=torch.complex64,
                    device=payload.device)
    X[:, :, occ] = payload.to(torch.complex64)
    x = torch.fft.ifft(X, dim=-1) * (M / np.sqrt(m_occ))
    with_cp = torch.cat([x[:, :, M - cfg.cp_len:], x], dim=-1)
    return with_cp.reshape(S, n_sym * cfg.symbol_len)


def generate_payload_symbols(cfg: ModemConfig, seed: int = 0) -> np.ndarray:
    """Random integer payload like the reference's rand()%ARITY stream
    (main.cc:1235-1238): [num_streams, pid_max * M_occupied] int32, the
    same numbers as the JAX package's for the same seed."""
    rng = np.random.default_rng(seed)
    n = cfg.pid_max * sctype.m_occupied(cfg)
    if cfg.mode.value in ("siso", "rx_diversity", "alamouti"):
        data = np.zeros((cfg.num_streams, n), dtype=np.int32)
        active = 0 if cfg.mode.value == "alamouti" else cfg.siso_tx
        data[active] = rng.integers(0, cfg.arity, size=n, dtype=np.int32)
    elif cfg.same_signal_on_all_tx:
        row = rng.integers(0, cfg.arity, size=n, dtype=np.int32)
        data = np.broadcast_to(row, (cfg.num_streams, n)).copy()
    else:
        data = rng.integers(0, cfg.arity, size=(cfg.num_streams, n),
                            dtype=np.int32)
    return data


def transmit_frame(cfg: ModemConfig, tx_data, *, device) -> torch.Tensor:
    """Full TX baseband signal: sync words then pid_max payload symbols,
    all scaled by baseband_gain (main.cc:1027-1112).

    tx_data: [num_streams, pid_max * M_occupied] integer symbols (numpy
    or tensor); returns [num_streams, total_len] complex64 on ``device``."""
    if cfg.mode != CommMode.RX_ZF:
        raise NotImplementedError(
            f"transmit_frame: mode {cfg.mode.value} is not ported yet")
    tx_data = torch.as_tensor(tx_data, device=device)
    m_occ = sctype.m_occupied(cfg)
    sig = constellation.modulate(tx_data, cfg.modulation)
    payload_t = assemble_payload(
        cfg, sig.reshape(cfg.num_streams, cfg.pid_max, m_occ))
    sync = torch.as_tensor(write_sync_words(cfg), device=device)
    out = torch.cat([sync, payload_t], dim=-1)
    return (out * cfg.baseband_gain).to(torch.complex64)
