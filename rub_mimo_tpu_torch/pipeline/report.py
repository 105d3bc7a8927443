"""Scoring and the experiment report of a decode.

Port of rub_mimo_tpu/pipeline/report.py (mimo/main.cc:1394-1470): the
symbol and bit error rates, EVM, plateau and sync statistics and the
decode rate, on numpy copies of the decode's tensors, with the same JSON
fields and printed lines as the JAX package.
"""

from __future__ import annotations

import dataclasses
import json
from typing import Dict, Optional

import numpy as np

from rub_mimo_tpu_torch.config import CommMode, ModemConfig, check_config
from rub_mimo_tpu_torch.ofdm import constellation, sctype
from rub_mimo_tpu_torch.pipeline.rx import DecodeResult


@dataclasses.dataclass
class ExperimentReport:
    synced: bool
    sync_index: int
    plateau_start: list
    plateau_end: list
    plateau_width: list
    num_occupied_carriers: int
    frames_decoded: int
    symbols_transmitted: int
    valid_symbols: list            # per stream
    symbol_error_rate: list        # per stream, in percent
    bit_error_rate: Optional[list] = None  # per stream, fraction
    evm_percent: Optional[list] = None     # per stream, None without rx_sig
    cfo_hat: float = 0.0
    samples_processed: int = 0
    decode_seconds: float = 0.0
    samples_per_second: float = 0.0
    extra: Dict = dataclasses.field(default_factory=dict)

    def to_json(self) -> str:
        return json.dumps(dataclasses.asdict(self), indent=2)

    def print(self) -> None:
        """The reference-style block (main.cc:1430-1469)."""
        r = self
        print(f"    synced                  : {r.synced}")
        for i, (ps, pe, pw) in enumerate(
                zip(r.plateau_start, r.plateau_end, r.plateau_width)):
            print(f"    plateau width {i+1}         : {pw:6d}")
            print(f"    plateau start {i+1}         : {ps:6d}")
            print(f"    plateau end   {i+1}         : {pe:6d}")
        print(f"    frames sync index       : {r.sync_index:6d}")
        print(f"    num samples processed   : {r.samples_processed:6d}")
        print(f"    num_occupied_carriers   : {r.num_occupied_carriers:6d}")
        print(f"    symbols transmitted     : {r.symbols_transmitted:6d}")
        for i, (v, ser) in enumerate(zip(r.valid_symbols,
                                         r.symbol_error_rate)):
            print(f"    valid symbols received {i}: {v:6d}")
            print(f"    symbol error rate      {i}: {ser:1.6f}%")
        if r.decode_seconds:
            print(f"    decode run time         : {r.decode_seconds:.4f} s")
            print(f"    samples / second        : "
                  f"{r.samples_per_second:.3e}")


def _bit_errors(a: np.ndarray, b: np.ndarray, bits: int) -> int:
    x = (a.astype(np.uint32) ^ b.astype(np.uint32)) & ((1 << bits) - 1)
    return int(np.unpackbits(x.view(np.uint8)).sum())


def score(result: DecodeResult, tx_data: np.ndarray, cfg: ModemConfig,
          decode_seconds: float = 0.0,
          num_samples: int = 0) -> ExperimentReport:
    """Compare decoded symbols with the ground truth (main.cc:1403-1411).
    The scored (rx, tx) stream pairs: (siso_rx, siso_tx) for SISO, the
    MRC output lane (siso_tx, siso_tx) for RX_DIVERSITY, (0, 0) for
    ALAMOUTI's one logical stream, else every stream s against tx stream
    s.  decode_seconds and num_samples (a stream's capture length) give
    the report's decode rate."""
    check_config(cfg, "report.score")
    rx_data = result.rx_data.cpu().numpy()
    rx_sig = None if result.rx_sig is None else result.rx_sig.cpu().numpy()
    tx_data = np.asarray(tx_data)
    n = cfg.pid_max * sctype.m_occupied(cfg)
    bits = cfg.modulation.bits_per_symbol
    table = constellation.table(cfg.modulation)

    if cfg.mode == CommMode.SISO:
        streams = [(cfg.siso_rx, cfg.siso_tx)]
    elif cfg.mode == CommMode.RX_DIVERSITY:
        streams = [(cfg.siso_tx, cfg.siso_tx)]
    elif cfg.mode == CommMode.ALAMOUTI:
        streams = [(0, 0)]
    else:
        streams = [(s, s) for s in range(cfg.num_streams)]

    valid, sers, bers, evms = [], [], [], []
    for rs, ts in streams:
        good = int((rx_data[rs, :n] == tx_data[ts, :n]).sum())
        valid.append(good)
        sers.append(float(n - good) / float(n) * 100.0)
        bers.append(_bit_errors(rx_data[rs, :n], tx_data[ts, :n], bits)
                    / float(n * bits))
        if rx_sig is not None:
            ideal = table[tx_data[ts, :n]]
            err = rx_sig[rs, :n] - ideal
            evms.append(float(np.sqrt(np.mean(np.abs(err) ** 2)
                                      / np.mean(np.abs(ideal) ** 2)) * 100.0))
    ps = result.plateau_start.cpu().tolist()
    pe = result.plateau_end.cpu().tolist()
    return ExperimentReport(
        synced=bool(result.synced),
        sync_index=int(result.sync_index),
        plateau_start=ps,
        plateau_end=pe,
        plateau_width=[int(e - s + 1) for s, e in zip(ps, pe)],
        num_occupied_carriers=sctype.m_occupied(cfg),
        frames_decoded=int(result.symbol_valid.sum()),
        symbols_transmitted=n * len(streams),
        valid_symbols=valid,
        symbol_error_rate=sers,
        bit_error_rate=bers,
        evm_percent=evms or None,
        cfo_hat=float(result.cfo_hat),
        samples_processed=num_samples,
        decode_seconds=decode_seconds,
        samples_per_second=(num_samples * cfg.num_streams / decode_seconds
                            if decode_seconds else 0.0),
    )
