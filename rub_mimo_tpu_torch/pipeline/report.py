"""Scoring: symbol/bit error rates and EVM of a decode.

Port of the scoring part of rub_mimo_tpu/pipeline/report.py::score
(mimo/main.cc:1394-1470), on numpy copies of the decode's tensors.
"""

from __future__ import annotations

import dataclasses
import json
from typing import Optional

import numpy as np

from rub_mimo_tpu_torch.config import CommMode, ModemConfig, check_config
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
    """Compare decoded symbols with the ground truth (main.cc:1403-1411).
    The scored (rx, tx) stream pairs: (siso_rx, siso_tx) for SISO, the
    MRC output lane (siso_tx, siso_tx) for RX_DIVERSITY, (0, 0) for
    ALAMOUTI's one logical stream, else every stream s against tx stream
    s."""
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
    return ExperimentReport(
        synced=bool(result.synced),
        sync_index=int(result.sync_index),
        frames_decoded=int(result.symbol_valid.sum()),
        symbols_transmitted=n * len(streams),
        valid_symbols=valid,
        symbol_error_rate=sers,
        bit_error_rate=bers,
        evm_percent=evms or None,
        cfo_hat=float(result.cfo_hat),
    )
