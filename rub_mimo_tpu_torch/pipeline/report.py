"""Scoring: symbol/bit error rates and EVM of a decode.

Port of the scoring part of rub_mimo_tpu/pipeline/report.py::score
(mimo/main.cc:1394-1470) for the RX_ZF mode, on numpy copies of the
decode's tensors.
"""

from __future__ import annotations

import dataclasses
import json
from typing import Optional

import numpy as np

from rub_mimo_tpu.config import ModemConfig
from rub_mimo_tpu_torch.ofdm import constellation, sctype
from rub_mimo_tpu_torch.pipeline.rx import DecodeResult


@dataclasses.dataclass
class ExperimentReport:
    synced: bool
    sync_index: int
    frames_decoded: int
    symbols_transmitted: int
    valid_symbols: list            # per stream
    symbol_error_rate: list        # per stream, in percent
    bit_error_rate: list           # per stream, fraction
    evm_percent: Optional[list]    # per stream, None without rx_sig
    cfo_hat: float

    def to_json(self) -> str:
        return json.dumps(dataclasses.asdict(self), indent=2)


def _bit_errors(a: np.ndarray, b: np.ndarray, bits: int) -> int:
    x = (a.astype(np.uint32) ^ b.astype(np.uint32)) & ((1 << bits) - 1)
    return int(np.unpackbits(x.view(np.uint8)).sum())


def score(result: DecodeResult, tx_data: np.ndarray,
          cfg: ModemConfig) -> ExperimentReport:
    """Compare decoded symbols with the ground truth (main.cc:1403-1411):
    stream s is scored against tx stream s."""
    rx_data = result.rx_data.cpu().numpy()
    rx_sig = None if result.rx_sig is None else result.rx_sig.cpu().numpy()
    tx_data = np.asarray(tx_data)
    n = cfg.pid_max * sctype.m_occupied(cfg)
    bits = cfg.modulation.bits_per_symbol
    table = constellation.table(cfg.modulation)

    valid, sers, bers, evms = [], [], [], []
    for s in range(cfg.num_streams):
        good = int((rx_data[s, :n] == tx_data[s, :n]).sum())
        valid.append(good)
        sers.append(float(n - good) / float(n) * 100.0)
        bers.append(_bit_errors(rx_data[s, :n], tx_data[s, :n], bits)
                    / float(n * bits))
        if rx_sig is not None:
            ideal = table[tx_data[s, :n]]
            err = rx_sig[s, :n] - ideal
            evms.append(float(np.sqrt(np.mean(np.abs(err) ** 2)
                                      / np.mean(np.abs(ideal) ** 2)) * 100.0))
    return ExperimentReport(
        synced=bool(result.synced),
        sync_index=int(result.sync_index),
        frames_decoded=int(result.symbol_valid.sum()),
        symbols_transmitted=n * cfg.num_streams,
        valid_symbols=valid,
        symbol_error_rate=sers,
        bit_error_rate=bers,
        evm_percent=evms or None,
        cfo_hat=float(result.cfo_hat),
    )
