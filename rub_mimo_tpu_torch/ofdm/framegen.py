"""TX frame generation: sync words + batched OFDM payload framing.

Port of rub_mimo_tpu/ofdm/framegen.py: every mode's TX, with one payload
per stream (RX_ZF and the beamforming modes), only siso_tx transmitting
(SISO, RX_DIVERSITY), or one stream space-time coded onto both antennas
(ALAMOUTI), and precoded TX (closed-loop beamforming, detect.precode):
a per-subcarrier precoder applied to the payload and to each TDMA
access-code slot, S0 staying on antenna 0.

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

from rub_mimo_tpu_torch.config import CommMode, ModemConfig, check_config
from rub_mimo_tpu_torch.detect import alamouti
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


def _occupied_on(cfg: ModemConfig, device) -> torch.Tensor:
    return torch.as_tensor(sctype.occupied_indices(sctype.allocation(cfg)),
                           device=device).long()


def assemble_payload(cfg: ModemConfig, payload: torch.Tensor,
                     precoder: torch.Tensor | None = None) -> torch.Tensor:
    """OFDM symbols with CP from constellation points.

    payload: [num_streams, num_symbols, M_occupied] complex
    precoder: optional [M_occupied, tx_antenna, stream] per-subcarrier
        precoding matrix (detect.precode): antenna a transmits
        sum_k P[sc, a, k] stream_k[sc]
    returns: [num_streams, num_symbols * symbol_len] complex64

    Occupied subcarriers get the payload in increasing subcarrier order,
    nulls 0; unnormalized IFFT scaled by 1/sqrt(M_occupied); the last
    cp_len samples prepended (framing.cc:210-235)."""
    occ = _occupied_on(cfg, payload.device)
    S, n_sym, m_occ = payload.shape
    M = cfg.M
    payload = payload.to(torch.complex64)
    if precoder is not None:
        payload = torch.einsum("sak,kns->ans",
                               precoder.to(torch.complex64), payload)
    X = torch.zeros((S, n_sym, M), dtype=torch.complex64,
                    device=payload.device)
    X[:, :, occ] = payload
    x = torch.fft.ifft(X, dim=-1) * (M / np.sqrt(m_occ))
    with_cp = torch.cat([x[:, :, M - cfg.cp_len:], x], dim=-1)
    return with_cp.reshape(S, n_sym * cfg.symbol_len)


def write_sync_words_precoded(cfg: ModemConfig,
                              precoder: torch.Tensor) -> torch.Tensor:
    """The sync-word block with the access codes precoded, on the
    precoder's device: S0 stays on antenna 0 (the S&C sync does not see
    the precoder), and the TDMA slot of (code, stream k) sends
    P[:, :, k] S1[k, code] from every antenna, so the receiver estimates
    the effective channel G @ P."""
    t = preamble.tables(cfg)
    dev = precoder.device
    S, M, cp, sym = cfg.num_streams, cfg.M, cfg.cp_len, cfg.symbol_len
    occ = _occupied_on(cfg, dev)
    out = torch.zeros((S, cfg.sync_words_len), dtype=torch.complex64,
                      device=dev)
    s0 = torch.as_tensor(t.s0, device=dev)
    out[0, cp:sym] = s0
    out[0, :cp] = s0[M - cp:]
    P = precoder.to(torch.complex64)  # [m_occ, antenna, stream]
    S1 = torch.as_tensor(t.S1, device=dev)[:, :, occ]  # [stream, code, occ]
    # every slot's spectrum at once: [code, stream k, antenna, M]
    X = torch.zeros((cfg.num_access_codes, S, S, M), dtype=torch.complex64,
                    device=dev)
    X[..., occ] = P.permute(2, 1, 0)[None] * S1.transpose(0, 1)[:, :, None]
    # FFTW_BACKWARD (= M ifft) scaled by 1/sqrt(M) (framing.cc:1228)
    x = torch.fft.ifft(X, dim=-1) * (M / np.sqrt(M))
    slots = torch.cat([x[..., M - cp:], x], dim=-1)  # [code, k, a, sym]
    # slot 1 + code*S + k, each antenna's row
    out[:, sym:] = slots.reshape(-1, S, sym).transpose(0, 1).reshape(S, -1)
    return out


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


def transmit_frame(cfg: ModemConfig, tx_data, *, device,
                   precoder=None) -> torch.Tensor:
    """Full TX baseband signal: sync words then pid_max payload symbols,
    all scaled by baseband_gain (main.cc:1027-1112).

    tx_data: [num_streams, pid_max * M_occupied] integer symbols (numpy
    or tensor); returns [num_streams, total_len] complex64 on ``device``.
    ALAMOUTI codes stream 0's symbols onto both antennas in pairs
    (detect.alamouti.encode_pairs); SISO and RX_DIVERSITY transmit on
    siso_tx only, the other streams zero (main.cc:1213-1219).  precoder:
    an optional [M_occupied, antenna, stream] matrix (detect.precode)
    applied to the access codes and the payload; ALAMOUTI refuses one (a
    precoder would remix the space-time code's antennas)."""
    check_config(cfg, "framegen.transmit_frame")
    if precoder is not None:
        if cfg.mode == CommMode.ALAMOUTI:
            raise ValueError(
                "ALAMOUTI mode cannot be combined with a precoder")
        precoder = torch.as_tensor(precoder, device=device)
    tx_data = torch.as_tensor(tx_data, device=device)
    m_occ = sctype.m_occupied(cfg)
    sig = constellation.modulate(tx_data, cfg.modulation)
    if cfg.mode == CommMode.ALAMOUTI:
        sig = alamouti.encode_pairs(sig[0].reshape(cfg.pid_max, m_occ))
    else:
        if cfg.mode in (CommMode.SISO, CommMode.RX_DIVERSITY):
            mask = torch.zeros((cfg.num_streams, 1), dtype=sig.dtype,
                               device=sig.device)
            mask[cfg.siso_tx, 0] = 1.0
            sig = sig * mask
        sig = sig.reshape(cfg.num_streams, cfg.pid_max, m_occ)
    payload_t = assemble_payload(cfg, sig, precoder)
    if precoder is None:
        sync = torch.as_tensor(write_sync_words(cfg), device=device)
    else:
        sync = write_sync_words_precoded(cfg, precoder)
    out = torch.cat([sync, payload_t], dim=-1)
    return (out * cfg.baseband_gain).to(torch.complex64)
