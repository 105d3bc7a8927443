"""Debug artifact dumps in the reference's /tmp layout.

Port of rub_mimo_tpu/pipeline/artifacts.py.  The reference logs every
buffer of every stage to binary files read by mimo/apps/plot.py: raw
tx/rx IQ, tx/rx symbol and data streams, the per-stream S&C metric
(f_sc_<n>.dat, framing.cc:598-600) and the per-(channel, sequence)
matched-filter traces (corr_<chan>_<ac>.dat, framing.cc:874-881).  This
module writes the same file set, in the same formats (io.capture), from
a DecodeResult of the port.
"""

from __future__ import annotations

import os
from pathlib import Path
from typing import Optional

import numpy as np
import torch

from rub_mimo_tpu_torch.config import ModemConfig, check_config
from rub_mimo_tpu_torch.io import capture as capio
from rub_mimo_tpu_torch.pipeline.rx import DecodeResult


def _host(x) -> np.ndarray:
    """A tensor (on any device) or array as a numpy array."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def dump(directory: str | os.PathLike, cfg: ModemConfig,
         result: DecodeResult, iq=None, tx_data: Optional[np.ndarray] = None,
         tx_sig=None) -> None:
    """Write the reference's artifact files (1-indexed stream suffixes):
    rx{n}.dat (iq), tx_data{n}.dat, tx_sig{n}.dat, rx_sig{n}.dat (when the
    decode kept rx_sig), rx_data{n}.dat, f_sc_{n}.dat and corr_{n}_{q}.dat
    (with keep_debug)."""
    check_config(cfg, "artifacts.dump")
    d = Path(directory)
    d.mkdir(parents=True, exist_ok=True)
    S = cfg.num_streams

    if iq is not None:
        capio.write_capture(d, _host(iq), prefix="rx")
    if tx_data is not None:
        for s in range(S):
            capio.write_data(d / f"tx_data{s + 1}.dat", _host(tx_data)[s])
    if tx_sig is not None:
        for s in range(S):
            capio.write_iq(d / f"tx_sig{s + 1}.dat", _host(tx_sig)[s])

    rx_data = _host(result.rx_data)
    rx_sig = None if result.rx_sig is None else _host(result.rx_sig)
    for s in range(S):
        if rx_sig is not None:
            capio.write_iq(d / f"rx_sig{s + 1}.dat", rx_sig[s])
        capio.write_data(d / f"rx_data{s + 1}.dat", rx_data[s])

    if result.metric is not None:
        m = _host(result.metric)
        for s in range(S):
            capio.write_metric(d / f"f_sc_{s + 1}.dat", m[s])

    if result.mf_traces is not None:
        # traces [streams, 1 + codes*streams, symbol_len]: the reference
        # numbers S0 as sequence 0 and the access codes 1..codes*streams
        tr = _host(result.mf_traces)
        for s in range(S):
            for q in range(tr.shape[1]):
                capio.write_metric(d / f"corr_{s + 1}_{q}.dat", tr[s, q])
