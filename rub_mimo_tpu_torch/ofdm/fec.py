"""Forward error correction: the convolutional code, puncturing, the
interleaver and the soft-decision Viterbi decoder.

Port of rub_mimo_tpu/ofdm/fec.py: the rate-1/2, constraint-length-7 code
with generators 171/133 octal (802.11a's), the 802.11a puncturing to
rates 2/3 and 3/4, a stride interleaver, and the soft Viterbi that closes
the loop from the max-log LLRs (ofdm/constellation.soft_demodulate_llr,
detect/ml.ml_soft_llrs) to the message bits.

The coded decode is two kernels on CUDA tensors: the soft-LLR kernel
(kernels/soft_llr.py::soft_llr_rows, csrc/soft_llr.cu) computes the LLRs
and writes them straight into the Viterbi's rows, with the deinterleave,
depuncture and window pads in its store (``row_plan`` says where each
LLR goes), and the Viterbi kernel (kernels/viterbi.py, csrc/viterbi.cu)
decodes every row in one launch.  On CPU tensors both run their plain
versions, the index gathers below and a Python loop over the steps: bit
for bit the JAX package's chain.  Each permutation or puncture index is
made once per length and device (utils/device_cache.py).  Long codewords
decode block-parallel: overlapping windows of 4096 steps with 128 steps
of margin on each side, each window a row of the kernel.

The TX side (``encode_payload``, ``encode_data``) returns numpy, as the
JAX package does, and its message comes from ``np.random.default_rng``:
the same seed gives the same message and symbols.

LLR convention: llr = log P(bit = 0) - log P(bit = 1) (positive -> bit
0), bits MSB-first within each symbol.
"""

from __future__ import annotations

import binascii
import functools
from typing import Tuple

import numpy as np
import torch

from rub_mimo_tpu_torch.config import ModemConfig, Modulation
from rub_mimo_tpu_torch.kernels import soft_llr
from rub_mimo_tpu_torch.kernels import viterbi as viterbi_kernel
from rub_mimo_tpu_torch.ofdm import constellation, sctype
from rub_mimo_tpu_torch.utils.device_cache import device_constant

K = viterbi_kernel.K              # constraint length
POLYS = viterbi_kernel.POLYS      # generator polynomials, MSB = current input
RATE_DEN = 2                      # mother code rate 1/2
N_STATES = viterbi_kernel.N_STATES
TAIL = K - 1
_trellis = viterbi_kernel.trellis

# 802.11a puncturing patterns over the interleaved (A1 B1 A2 B2 ...) coded
# stream; 1 = transmit, 0 = puncture (depunctured as zero LLRs at RX)
PUNCTURE = {
    "1/2": None,
    "2/3": (1, 1, 1, 0),
    "3/4": (1, 1, 1, 0, 0, 1),
}

INTERLEAVE_SPREAD = 127
_PAD_LLR = 1e4  # "coded bit is certainly 0": the encoder reset and the tail
_HEADER_BITS = 64  # 32-bit length (bytes) + 32-bit CRC-32


def _kept_bits(L: int, rate: str) -> int:
    """Punctured (transmitted) length of an L-bit mother-coded stream."""
    pat = PUNCTURE[rate]
    if pat is None:
        return L
    P = len(pat)
    return (L // P) * sum(pat) + sum(pat[: L % P])


@device_constant
def _kept_index(L: int, rate: str, device: torch.device) -> torch.Tensor:
    """The positions of the transmitted bits of an L-bit stream."""
    pat = PUNCTURE[rate]
    mask = np.tile(np.asarray(pat, bool), -(-L // len(pat)))[:L]
    return torch.as_tensor(np.flatnonzero(mask), device=device)


def puncture(coded: torch.Tensor, rate: str) -> torch.Tensor:
    """[..., L] mother-coded bits -> [..., kept] transmitted bits."""
    if PUNCTURE[rate] is None:
        return coded
    return coded.index_select(-1, _kept_index(coded.shape[-1], rate,
                                              coded.device))


def depuncture_llrs(llrs: torch.Tensor, L: int, rate: str) -> torch.Tensor:
    """[..., kept] received LLRs -> [..., L] with zero LLRs (erasures) at
    the punctured positions."""
    if PUNCTURE[rate] is None:
        return llrs[..., :L]
    idx = _kept_index(L, rate, llrs.device)
    out = torch.zeros(llrs.shape[:-1] + (L,), dtype=llrs.dtype,
                      device=llrs.device)
    return out.index_copy_(out.dim() - 1, idx, llrs[..., : idx.numel()])


def conv_encode(bits: torch.Tensor) -> torch.Tensor:
    """Rate-1/2 K=7 encoder with zero-tail termination on bits' device:
    [..., n] in {0, 1} -> coded [..., 2 * (n + TAIL)] int32.  Coded bit g
    at time t is the parity of the K newest input bits under POLYS[g]."""
    bits = bits.to(torch.int32)
    n = bits.shape[-1]
    zeros = torch.zeros(bits.shape[:-1] + (K - 1,), dtype=torch.int32,
                        device=bits.device)
    padded = torch.cat([zeros, bits, zeros[..., :TAIL]], dim=-1)
    total = n + TAIL
    streams = []
    for g in POLYS:
        acc = torch.zeros(bits.shape[:-1] + (total,), dtype=torch.int32,
                          device=bits.device)
        for k in range(K):  # tap k: input bit t - k (k = 0 the current)
            if (g >> (K - 1 - k)) & 1:
                acc ^= padded[..., K - 1 - k: K - 1 - k + total]
        streams.append(acc)
    return torch.stack(streams, dim=-1).reshape(*bits.shape[:-1], 2 * total)


def viterbi_rows(llrs: torch.Tensor, window: int | None = None,
                 margin: int = 128):
    """The Viterbi kernel's rows for llrs [B, 2*T]: (pairs [rows, span, 2]
    float32, pinned [rows] bool).  window=None: one pinned row per
    codeword (start and end state 0, span T).  An integer window: each
    codeword padded with +_PAD_LLR pairs ("certainly 0": the encoder reset
    on the left, the zero tail on the right) and cut into ceil(T / window)
    overlapping rows of window + 2*margin steps, each from a uniform
    prior with a traceback from its best state."""
    B, T = llrs.shape[0], llrs.shape[-1] // 2
    pairs = llrs[:, : 2 * T].to(torch.float32).reshape(B, T, 2)
    if window is None:
        return (pairs.contiguous(),
                torch.ones((B,), dtype=torch.bool, device=llrs.device))
    W = int(window)
    nW = -(-T // W)
    span = W + 2 * margin
    padded = torch.full((B, nW * W + 2 * margin, 2), _PAD_LLR,
                        dtype=torch.float32, device=llrs.device)
    padded[:, margin: margin + T] = pairs
    wins = padded.unfold(1, span, W).transpose(-1, -2)  # [B, nW, span, 2]
    return (wins.reshape(B * nW, span, 2).contiguous(),
            torch.zeros((B * nW,), dtype=torch.bool, device=llrs.device))


def viterbi_decode(llrs: torch.Tensor, window: int | None = None,
                   margin: int = 128) -> torch.Tensor:
    """Soft-decision Viterbi.  llrs [..., 2*(n+TAIL)] -> bits [..., n]
    int32 (tail stripped), every row in one kernel launch.

    window=None decodes each codeword in one scan: the exact
    maximum-likelihood path.  An integer window decodes overlapping
    windows of window + 2*margin steps block-parallel and keeps each
    window's interior (``viterbi_rows``), the serving mode for long
    codewords."""
    shape = llrs.shape
    flat = llrs.reshape(-1, shape[-1])
    bits = viterbi_kernel.viterbi(*viterbi_rows(flat, window, margin))
    return _message(bits, flat.shape[0], shape[-1] // 2, window,
                    margin).reshape(*shape[:-1], -1)


def _message(bits: torch.Tensor, B: int, T: int, window: int | None,
             margin: int) -> torch.Tensor:
    """The Viterbi's decoded rows [B * rows, steps] -> the message bits
    [B, T - TAIL]: each window's interior end to end, the tail dropped."""
    if window is not None:
        W = int(window)
        bits = bits.reshape(B, -1, W + 2 * margin)[:, :, margin: margin + W]
        bits = bits.reshape(B, -1)[:, :T]
    return bits[:, : T - TAIL]


# --------------------------------------------------------------- packing
@device_constant
def _shifts(b: int, device: torch.device) -> torch.Tensor:
    """[b] int32 b-1, ..., 1, 0: each bit's place, MSB first."""
    return torch.arange(b - 1, -1, -1, dtype=torch.int32, device=device)


def bits_to_symbols(bits: torch.Tensor, modulation: Modulation
                    ) -> torch.Tensor:
    """Pack bits (MSB-first, soft_demodulate_llr's order) into integer
    symbols: [..., n*b] -> [..., n] int32."""
    b = modulation.bits_per_symbol
    g = bits.reshape(*bits.shape[:-1], -1, b).to(torch.int32)
    weights = 1 << _shifts(b, bits.device)
    return (g * weights).sum(dim=-1).to(torch.int32)


def symbols_to_bits(symbols: torch.Tensor, modulation: Modulation
                    ) -> torch.Tensor:
    """[..., n] integer symbols -> [..., n*b] int32 bits, MSB first."""
    b = modulation.bits_per_symbol
    bits = (symbols[..., None].to(torch.int32)
            >> _shifts(b, symbols.device)) & 1
    return bits.reshape(*symbols.shape[:-1], -1)


# ------------------------------------------------------- interleaving
def interleave_stride(n: int, spread: int) -> int:
    """The interleaver's stride: the smallest s >= spread coprime to n."""
    s = max(int(spread), 1)
    while np.gcd(s, n) != 1:
        s += 1
    return s


@functools.lru_cache(maxsize=None)
def _interleave_perm(n: int, spread: int) -> np.ndarray:
    """Stride permutation: out[i] = in[perm[i]] with perm[i] = (i * s) % n
    for s = interleave_stride(n, spread), so adjacent coded bits land ~s
    positions apart, far beyond the K = 7 memory."""
    return (np.arange(n, dtype=np.int64) * interleave_stride(n, spread)) % n


@device_constant
def _perm_on(n: int, spread: int, inverse: bool, device: torch.device
             ) -> torch.Tensor:
    perm = _interleave_perm(n, spread)
    if inverse:
        inv = np.empty_like(perm)
        inv[perm] = np.arange(n, dtype=np.int64)
        perm = inv
    return torch.as_tensor(perm, device=device)


def interleave(bits: torch.Tensor, spread: int) -> torch.Tensor:
    """[..., n] -> [..., n] stride interleaver (pair with deinterleave)."""
    return bits.index_select(-1, _perm_on(bits.shape[-1], spread, False,
                                          bits.device))


def deinterleave(x: torch.Tensor, spread: int) -> torch.Tensor:
    return x.index_select(-1, _perm_on(x.shape[-1], spread, True, x.device))


# ----------------------------------------------------- payload plumbing
def _lanes(cfg: ModemConfig) -> Tuple[list, list]:
    """(tx lanes carrying data, rx output lanes): the one-logical-stream
    conventions of framegen.generate_payload_symbols and report.score."""
    mode = cfg.mode.value
    if mode == "siso":
        return [cfg.siso_tx], [cfg.siso_rx]
    if mode == "rx_diversity":
        return [cfg.siso_tx], [cfg.siso_tx]
    if mode == "alamouti":
        return [0], [0]
    return list(range(cfg.num_streams)), list(range(cfg.num_streams))


def message_bits_per_stream(cfg: ModemConfig, rate: str = "1/2") -> int:
    """Message (info) bits per stream at the code rate (mother 1/2,
    puncturing, tail) over the pid_max * M_occupied symbol budget."""
    budget = cfg.pid_max * cfg.M_occupied * cfg.modulation.bits_per_symbol
    if PUNCTURE[rate] is None:
        return budget // RATE_DEN - TAIL
    pat = PUNCTURE[rate]
    n = (budget * len(pat)) // (2 * sum(pat)) - TAIL
    while _kept_bits(2 * (n + TAIL), rate) > budget:
        n -= 1
    while _kept_bits(2 * (n + 1 + TAIL), rate) <= budget:
        n += 1
    return n


def data_capacity_bytes(cfg: ModemConfig, rate: str = "1/2") -> int:
    """Most user-data bytes one coded payload carries (all lanes pooled,
    less the length + CRC header); 0 if it cannot carry the header."""
    tx_lanes, _ = _lanes(cfg)
    total_bits = len(tx_lanes) * message_bits_per_stream(cfg, rate)
    if total_bits < _HEADER_BITS:
        return 0
    return (total_bits - _HEADER_BITS) // 8


def _msg_to_tx_data(msg: np.ndarray, cfg: ModemConfig, rate: str,
                    interleave_bits: bool) -> np.ndarray:
    """[n_lanes, n_msg] message bits -> tx_data [num_streams, n_sym] int32
    symbols (encode, puncture, pad, interleave, pack, lane scatter), on
    the host."""
    tx_lanes, _ = _lanes(cfg)
    n_sym = cfg.pid_max * cfg.M_occupied
    bps = cfg.modulation.bits_per_symbol
    coded = puncture(conv_encode(torch.from_numpy(msg)), rate)
    coded = torch.nn.functional.pad(coded, (0, n_sym * bps - coded.shape[-1]))
    if interleave_bits:
        coded = interleave(coded, INTERLEAVE_SPREAD)
    tx_data = np.zeros((cfg.num_streams, n_sym), dtype=np.int32)
    tx_data[tx_lanes] = bits_to_symbols(coded, cfg.modulation).numpy()
    return tx_data


def encode_payload(cfg: ModemConfig, seed: int = 0, *,
                   interleave_bits: bool = True, rate: str = "1/2"
                   ) -> Tuple[np.ndarray, np.ndarray]:
    """A random coded payload: (msg_bits [n_lanes, n_msg] int32, tx_data
    [num_streams, pid_max * M_occupied] int32 symbols), numpy, equal to
    the JAX package's for the same seed.  Coded bits past the last whole
    symbol are zero padding; interleave_bits spreads adjacent coded bits
    over far-apart symbols (decode_payload must match); rate selects the
    puncturing: '1/2', '2/3', '3/4'."""
    rng = np.random.default_rng(seed)
    n_msg = message_bits_per_stream(cfg, rate)
    tx_lanes, _ = _lanes(cfg)
    msg = rng.integers(0, 2, size=(len(tx_lanes), n_msg),
                       dtype=np.int64).astype(np.int32)
    return msg, _msg_to_tx_data(msg, cfg, rate, interleave_bits)


def encode_data(data: bytes, cfg: ModemConfig, *, rate: str = "1/2",
                interleave_bits: bool = True) -> np.ndarray:
    """Real bytes into coded payload symbols: [32-bit length][32-bit
    CRC-32][data bits][zero pad], split across the mode's data lanes,
    encoded per lane.  Returns tx_data [num_streams, pid_max *
    M_occupied] int32 (numpy)."""
    tx_lanes, _ = _lanes(cfg)
    n_msg = message_bits_per_stream(cfg, rate)
    if len(tx_lanes) * n_msg < _HEADER_BITS:
        raise ValueError(
            "payload too small to carry the 64-bit length+CRC header")
    cap = data_capacity_bytes(cfg, rate)
    if len(data) > cap:
        raise ValueError(f"{len(data)} bytes exceed the payload capacity "
                         f"{cap}")
    header = np.frombuffer(
        np.uint32(len(data)).tobytes()
        + np.uint32(binascii.crc32(data) & 0xFFFFFFFF).tobytes(), np.uint8)
    bits = np.unpackbits(np.concatenate([header,
                                         np.frombuffer(data, np.uint8)]))
    msg = np.zeros(len(tx_lanes) * n_msg, np.int32)
    msg[: bits.size] = bits
    return _msg_to_tx_data(msg.reshape(len(tx_lanes), n_msg), cfg, rate,
                           interleave_bits)


def decode_data(rx_sig, cfg: ModemConfig, *, rate: str = "1/2",
                interleave_bits: bool = True, noise_var: float = 1.0):
    """Inverse of encode_data: (data bytes, crc_ok).  rx_sig is the
    equalized symbols or a whole DecodeResult; an ML decode (its Y kept)
    goes through the joint soft LLRs (decode_payload_ml), since its
    rx_sig holds hard remodulated points.  A garbled header gives
    (b'', False)."""
    if hasattr(rx_sig, "rx_sig"):  # a DecodeResult
        result = rx_sig
        if result.Y is not None:
            msg = decode_payload_ml(result, cfg, noise_var,
                                    interleave_bits=interleave_bits,
                                    rate=rate)
        else:
            msg = decode_payload(result.rx_sig, cfg, noise_var,
                                 interleave_bits=interleave_bits, rate=rate)
    else:
        msg = decode_payload(rx_sig, cfg, noise_var,
                             interleave_bits=interleave_bits, rate=rate)
    msg = msg.cpu().numpy()
    if msg.size < _HEADER_BITS:
        return b"", False
    bits = msg.reshape(-1)
    header = np.packbits(bits[:_HEADER_BITS].astype(np.uint8))
    length = int(np.frombuffer(header[:4].tobytes(), np.uint32)[0])
    crc_want = int(np.frombuffer(header[4:8].tobytes(), np.uint32)[0])
    if length > data_capacity_bytes(cfg, rate):
        return b"", False
    body = bits[_HEADER_BITS: _HEADER_BITS + 8 * length]
    data = np.packbits(body.astype(np.uint8)).tobytes()[:length]
    return data, (binascii.crc32(data) & 0xFFFFFFFF) == crc_want


def decode_payload(rx_sig: torch.Tensor, cfg: ModemConfig,
                   noise_var: float | torch.Tensor = 1.0, *,
                   interleave_bits: bool = True, rate: str = "1/2"
                   ) -> torch.Tensor:
    """Equalized symbols [S, pid_max * M_occupied] -> message bits
    [L, n_msg] int32 on rx_sig's device: max-log LLRs, deinterleave,
    depuncture, drop the padding, Viterbi."""
    _, rx_lanes = _lanes(cfg)
    y = (rx_sig if rx_lanes == list(range(rx_sig.shape[0]))
         else torch.stack([rx_sig[lane] for lane in rx_lanes]))
    y = y.reshape(len(rx_lanes), -1)
    return _decode_rows(y, cfg, interleave_bits, rate,
                        constellation.table(cfg.modulation), noise_var)


def row_plan(n: int, cfg: ModemConfig, rate: str = "1/2",
             interleave_bits: bool = True) -> soft_llr.RowPlan:
    """Where the Viterbi's rows take the LLRs of a lane of n wire LLRs
    from: deinterleaved (interleave_bits), the first kept(used) of them
    depunctured into used = 2 (n_msg + TAIL) LLRs; long codewords in
    windows of 4096 steps with 128 of margin (block-parallel), short ones
    in one pinned row (the exact scan)."""
    n_msg = message_bits_per_stream(cfg, rate)
    return soft_llr.RowPlan(
        used=2 * (n_msg + TAIL), rate=rate,
        stride=(interleave_stride(n, INTERLEAVE_SPREAD) if interleave_bits
                else 1),
        window=4096 if n_msg + TAIL > 4 * 4096 else None, margin=128)


def _decode_rows(x: torch.Tensor, cfg: ModemConfig, interleave_bits: bool,
                 rate: str, points=None, noise_var=1.0) -> torch.Tensor:
    """Symbols [L, N] (over ``points``) or wire-order LLRs [L, n] ->
    message bits [L, n_msg]: the soft-LLR kernel's rows, the Viterbi."""
    n = x.shape[1] * (1 if x.dtype == torch.float32 else
                      cfg.modulation.bits_per_symbol)
    plan = row_plan(n, cfg, rate, interleave_bits)
    pairs, pinned = soft_llr.soft_llr_rows(x, plan, points, noise_var)
    return _message(viterbi_kernel.viterbi(pairs, pinned), x.shape[0],
                    plan.used // 2, plan.window, plan.margin)


def _decode_from_llrs(llrs: torch.Tensor, cfg: ModemConfig,
                      interleave_bits: bool, rate: str = "1/2"
                      ) -> torch.Tensor:
    """[L, n_coded] LLRs in TX wire order -> message bits [L, n_msg]."""
    return _decode_rows(llrs.to(torch.float32), cfg, interleave_bits, rate)


def decode_payload_ml(result, cfg: ModemConfig,
                      noise_var: float | torch.Tensor = 1.0, *,
                      interleave_bits: bool = True, rate: str = "1/2"
                      ) -> torch.Tensor:
    """Coded decode with joint soft-output ML demapping: the LLRs of
    detect.ml.ml_soft_llrs over the raw payload grid (result.Y, kept by
    the decode when cfg.detector is ML), which marginalizes the
    inter-stream interference in the lattice.  Full-MIMO modes only."""
    from rub_mimo_tpu_torch.detect import ml as ml_mod

    if result.Y is None:
        raise ValueError(
            "result.Y missing: decode with cfg.detector == Detector.ML")
    G = result.G
    occ = sctype.occupied_indices(sctype.allocation(cfg))
    if occ.size != cfg.M:
        G = G.index_select(0, torch.as_tensor(occ, device=G.device))
    llrs = ml_mod.ml_soft_llrs(result.Y, G, cfg, noise_var)
    # [n_sym, tx, n_sc, bps] -> TX wire order [L, (frame, sc, bit)]
    llrs = llrs.transpose(0, 1).reshape(cfg.num_streams, -1)
    return _decode_from_llrs(llrs, cfg, interleave_bits, rate)
