"""Named system presets: the port's copy of rub_mimo_tpu/models/presets.py.

Each preset returns the port's (ModemConfig, io.simulator.ChannelSpec),
with the same fields as the JAX package's preset of the same name.
"""

from __future__ import annotations

from typing import Dict, Tuple

from rub_mimo_tpu_torch.config import (CommMode, Detector, ModemConfig,
                                       Modulation)
from rub_mimo_tpu_torch.io.simulator import ChannelSpec


def siso_loopback(**kw) -> Tuple[ModemConfig, ChannelSpec]:
    """Config 1: 1x1 SISO OFDM loopback — QPSK through AWGN."""
    cfg = ModemConfig(num_streams=1, mode=CommMode.SISO, siso_tx=0,
                      siso_rx=0, modulation=Modulation.QPSK, bit_exact=False,
                      **kw)
    return cfg, ChannelSpec(snr_db=25.0, delay=4096, identity=True, seed=1)


def siso_capture(**kw) -> Tuple[ModemConfig, ChannelSpec]:
    """Config 2: 1x1 OFDM over a recorded capture — sync + CFO + LS."""
    cfg = ModemConfig(num_streams=1, mode=CommMode.SISO, siso_tx=0,
                      siso_rx=0, modulation=Modulation.QPSK, correct_cfo=True,
                      bit_exact=False, **kw)
    return cfg, ChannelSpec(snr_db=25.0, delay=4096, cfo_subcarriers=0.05,
                            seed=2)


def mimo_2x2_zf(**kw) -> Tuple[ModemConfig, ChannelSpec]:
    """Config 3: 2x2 MIMO-OFDM, pilot channel estimation + ZF, 16-QAM."""
    cfg = ModemConfig(modulation=Modulation.QAM16, detector=Detector.ZF,
                      bit_exact=False, **kw)
    return cfg, ChannelSpec(snr_db=30.0, delay=5000, seed=3)


def mimo_2x2_reference(**kw) -> Tuple[ModemConfig, ChannelSpec]:
    """The reference's exact default build: 32-ary modem, bit-exact
    estimator quirks (mimo/config.h defaults)."""
    cfg = ModemConfig(bit_exact=True, **kw)
    return cfg, ChannelSpec(snr_db=30.0, delay=5000, seed=42)


def mimo_2x2_mmse(**kw) -> Tuple[ModemConfig, ChannelSpec]:
    """Config 4: 2x2 MIMO-OFDM with MMSE detection, long stream."""
    cfg = ModemConfig(modulation=Modulation.QAM16, detector=Detector.MMSE,
                      mmse_noise_var=1e-3, bit_exact=False, **kw)
    return cfg, ChannelSpec(snr_db=25.0, delay=5000, seed=5)


def mimo_4x4_wideband(**kw) -> Tuple[ModemConfig, ChannelSpec]:
    """Config 5: 4x4 MIMO wideband, MMSE, the quorum plateau rule (>= 3
    of 4 streams)."""
    cfg = ModemConfig(num_streams=4, modulation=Modulation.QAM16,
                      detector=Detector.MMSE, mmse_noise_var=1e-3,
                      bit_exact=False, sync_quorum=3, **kw)
    return cfg, ChannelSpec(snr_db=35.0, delay=5000, seed=6)


def wifi_like(**kw) -> Tuple[ModemConfig, ChannelSpec]:
    """An 802.11a-shaped PHY: 64 subcarriers with guard bands + pilots,
    16-sample CP, 16-QAM, CFO correction, S0 fallback acquisition, over a
    3-tap channel.  Its uncoded symbol error rate is not 0: the preset
    pairs with forward error correction."""
    base = dict(num_subcarriers=64, cp_len=16, num_streams=1,
                mode=CommMode.SISO, siso_tx=0, siso_rx=0, num_access_codes=4,
                use_all_carriers=False, modulation=Modulation.QAM16,
                correct_cfo=True, sync_fallback=True, bit_exact=False,
                pid_max=100)
    base.update(kw)
    return ModemConfig(**base), ChannelSpec(
        snr_db=22.0, delay=777, cfo_subcarriers=0.03, flat=False, num_taps=3,
        seed=7)


PRESETS: Dict[str, callable] = {
    "siso_loopback": siso_loopback,
    "siso_capture": siso_capture,
    "mimo_2x2_zf": mimo_2x2_zf,
    "mimo_2x2_reference": mimo_2x2_reference,
    "mimo_2x2_mmse": mimo_2x2_mmse,
    "mimo_4x4_wideband": mimo_4x4_wideband,
    "wifi_like": wifi_like,
}


def get(name: str, **kw) -> Tuple[ModemConfig, ChannelSpec]:
    return PRESETS[name](**kw)
