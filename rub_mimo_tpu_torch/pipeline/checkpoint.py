"""Checkpoint and resume for decode runs.

Port of rub_mimo_tpu/pipeline/checkpoint.py.  The capture file stays the
durable input (the reference's record-then-replay design, mimo/main.cc:
881-887, 906-922); the derived state of a decode (sync index, channel
estimate, equalizer weights, decisions, CFO) is one .npz with the same
keys and dtypes as the JAX package's, so a checkpoint written by either
package loads in the other:

  - ``save`` after a decode stores that state;
  - ``resume_decode`` re-equalizes a capture from the saved sync, W and
    gain, skipping the sync, matched filter and estimation: frame k
    always maps to the same capture samples, so a run can restart at any
    frame.
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np
import torch

from rub_mimo_tpu_torch.config import CommMode, ModemConfig, check_config
from rub_mimo_tpu_torch.detect import alamouti, diversity, postprocess
from rub_mimo_tpu_torch.detect import siso, zf
from rub_mimo_tpu_torch.kernels import cp_strip as cp_strip_mod
from rub_mimo_tpu_torch.kernels import payload_fused
from rub_mimo_tpu_torch.ofdm import constellation
from rub_mimo_tpu_torch.pipeline import rx
from rub_mimo_tpu_torch.pipeline.rx import DecodeResult
from rub_mimo_tpu_torch.utils.device import on_device


def _np(x: torch.Tensor, dtype) -> np.ndarray:
    return x.detach().cpu().numpy().astype(dtype)


def save(path: str | os.PathLike, cfg: ModemConfig,
         result: DecodeResult) -> None:
    """Write the decode's state as a compressed .npz (one read of the
    result's tensors)."""
    check_config(cfg, "checkpoint.save")
    np.savez_compressed(
        path,
        config_json=np.frombuffer(cfg.to_json().encode(), dtype=np.uint8),
        synced=np.int32(bool(result.synced)),
        sync_index=np.int64(int(result.sync_index)),
        decode_start=np.int64(int(result.decode_start)),
        plateau_start=_np(result.plateau_start, np.int32),
        plateau_end=_np(result.plateau_end, np.int32),
        cfo_hat=np.float32(float(result.cfo_hat)),
        cfo_coarse=np.float32(float(result.cfo_coarse)),
        G=_np(result.G, np.complex64),
        W=_np(result.W, np.complex64),
        normalize_gain=_np(result.normalize_gain, np.float32),
        ac_index=_np(result.ac_index, np.int32),
        rx_data=_np(result.rx_data, np.int32),
        symbol_valid=_np(result.symbol_valid, bool),
    )


class Checkpoint:
    """A loaded checkpoint: the config and the saved state as numpy."""

    def __init__(self, path: str | os.PathLike):
        with np.load(path) as z:
            self.config = ModemConfig.from_json(
                bytes(z["config_json"]).decode())
            self.synced = bool(z["synced"])
            self.sync_index = int(z["sync_index"])
            self.decode_start = int(z["decode_start"])
            self.plateau_start = z["plateau_start"]
            self.plateau_end = z["plateau_end"]
            self.cfo_hat = float(z["cfo_hat"])
            self.cfo_coarse = (float(z["cfo_coarse"]) if "cfo_coarse" in z
                               else 0.0)
            self.G = z["G"]
            self.W = z["W"]
            self.normalize_gain = z["normalize_gain"]
            self.ac_index = z["ac_index"]
            self.rx_data = z["rx_data"]
            self.symbol_valid = z["symbol_valid"]


def load(path: str | os.PathLike) -> Checkpoint:
    return Checkpoint(path)


def resume_decode(capture, ckpt: Checkpoint, from_frame: int = 0,
                  cfg: Optional[ModemConfig] = None, *, device):
    """Re-equalize a capture on ``device`` with the checkpointed sync and
    channel state: (rx_sig [S, n*M_occ] complex64, rx_data int32) of
    frames [from_frame, pid_max), n = pid_max - from_frame.

    The saved CFO is undone over the capture as the decode applied it
    (correct_cfo).  The payload tail is the decode's: K1 where the payload
    kernels apply (rx.kernel_applicable), else the CP strip (K7), the FFT
    and the mode's combining (SISO, MRC, Alamouti pairs; ZF with the saved
    W and gain otherwise), the postprocess and the hard demap (K4 on
    CUDA).  from_frame must be even for ALAMOUTI (the pairing)."""
    cfg = cfg or ckpt.config
    check_config(cfg, "checkpoint.resume_decode")
    if cfg.mode == CommMode.ALAMOUTI and from_frame % 2:
        raise ValueError("ALAMOUTI resume requires an even from_frame")
    device = on_device(device)
    S, sym, M = cfg.num_streams, cfg.symbol_len, cfg.M
    n_sym = cfg.pid_max - from_frame
    # the capture offset of frame from_frame; a negative start reads from
    # the capture's first sample, as the JAX package's slice does
    start = max(ckpt.sync_index - sym + ckpt.decode_start
                + from_frame * sym, 0)
    iq = torch.as_tensor(capture, dtype=torch.complex64, device=device)
    W = torch.as_tensor(ckpt.W, device=device)
    gain = torch.as_tensor(ckpt.normalize_gain, device=device)
    G_occ = rx.occupied_channel(torch.as_tensor(ckpt.G, device=device), cfg)

    # the CFO the decode removed: the coarse part with phase reference 0,
    # the residual with the window's start (sync_index - symbol_len)
    eps_c = np.float32(ckpt.cfo_coarse)
    eps_r = np.float32(ckpt.cfo_hat - ckpt.cfo_coarse)
    if cfg.correct_cfo and (eps_c != 0.0 or eps_r != 0.0):
        g = torch.arange(iq.shape[-1], dtype=torch.float32, device=device)
        phase = (float(eps_c) * g
                 + float(eps_r) * (g - float(np.float32(ckpt.sync_index
                                                        - sym))))
        iq = (iq * torch.exp(-2j * np.pi * phase / M)).to(torch.complex64)
    payload = rx.extract_payload(iq, start, n_sym * sym)

    table = constellation.table(cfg.modulation)
    if rx.kernel_applicable(cfg, "auto"):
        sig, data = payload_fused.payload_fused_strip(
            payload.real.contiguous(), payload.imag.contiguous(), W, gain,
            table, np.float32(1.0 / np.sqrt(cfg.M_occupied)), n_sym=n_sym,
            symbol_len=sym, cp_len=cfg.cp_len)
        return sig.reshape(S, -1), data.reshape(S, -1)
    Y = rx.symbol_grid(cp_strip_mod.cp_strip(payload, n_sym, sym,
                                             cfg.cp_len), cfg)
    eq = torch.zeros_like(Y)
    if cfg.mode == CommMode.SISO:
        eq[:, cfg.siso_rx, :] = siso.siso_equalize(Y, G_occ, cfg.siso_rx,
                                                   cfg.siso_tx)
    elif cfg.mode == CommMode.RX_DIVERSITY:
        # the saved W is a zero placeholder here: combine from the saved
        # channel estimate
        eq[:, cfg.siso_tx, :] = diversity.mrc_combine(Y, G_occ, cfg.siso_tx)
    elif cfg.mode == CommMode.ALAMOUTI:
        eq[:, 0, :] = alamouti.combine_pairs(Y, G_occ)
    else:
        eq = zf.equalize(Y, W, gain)
    eq = postprocess.postprocess_eq(eq, cfg)
    rx_sig = eq.transpose(0, 1).reshape(S, -1)
    return rx_sig, constellation.demodulate(rx_sig, cfg.modulation)
