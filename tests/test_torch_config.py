"""The port's own configuration (rub_mimo_tpu_torch.config) against the JAX
package's rub_mimo_tpu/config.py: the same fields, types and defaults,
the same derived properties and JSON, the same validation rules; the
presets' copies; and the conversion the entry points require."""

import dataclasses
import enum
import json

import numpy as np
import pytest
import torch

from rub_mimo_tpu import config as jconfig
from rub_mimo_tpu.models import presets as jpresets
from rub_mimo_tpu_torch import config, convert
from rub_mimo_tpu_torch.io import simulator
from rub_mimo_tpu_torch.models import presets
from rub_mimo_tpu_torch.pipeline import report, rx
import torch_oracle as oracle

PROPS = ("M", "M2", "symbol_len", "num_sync_symbols", "sync_words_len",
         "access_code_buffer_len", "tx_sig_samples", "window_len", "arity",
         "M_occupied")


def _default(f):
    """A field's default, enums by value (the two packages' enum classes
    differ)."""
    return f.default.value if isinstance(f.default, enum.Enum) else f.default


def test_fields_types_and_defaults_equal():
    jf = dataclasses.fields(jconfig.ModemConfig)
    pf = dataclasses.fields(config.ModemConfig)
    assert [f.name for f in pf] == [f.name for f in jf]
    for a, b in zip(pf, jf):
        assert a.type == b.type, a.name
        assert _default(a) == _default(b), a.name
        assert a.default_factory is b.default_factory, a.name
    for name in ("CommMode", "Detector", "Modulation"):
        assert ([(e.name, e.value) for e in getattr(config, name)]
                == [(e.name, e.value) for e in getattr(jconfig, name)])
    for m in config.Modulation:
        jm = jconfig.Modulation(m.value)
        assert (m.bits_per_symbol, m.arity) == (jm.bits_per_symbol, jm.arity)
    for k in ("LFSR_SMALL_LENGTH", "LFSR_LARGE_LENGTH",
              "LFSR_SMALL_0_GEN_POLY", "LFSR_SMALL_1_GEN_POLY",
              "LFSR_LARGE_0_GEN_POLY", "LFSR_LARGE_1_GEN_POLY"):
        assert getattr(config, k) == getattr(jconfig, k), k


CONFIGS = {
    "default": (config.DEFAULT_CONFIG, jconfig.DEFAULT_CONFIG),
    "tiny": (config.tiny_config(), jconfig.tiny_config()),
    "tiny_guard": (config.tiny_config(use_all_carriers=False),
                   jconfig.tiny_config(use_all_carriers=False)),
    "guard_no_null": (
        config.ModemConfig(use_all_carriers=False, add_null_carriers=False),
        jconfig.ModemConfig(use_all_carriers=False, add_null_carriers=False)),
    **{name: (presets.get(name)[0], jpresets.get(name)[0])
       for name in jpresets.PRESETS},
}


@pytest.mark.parametrize("name", list(CONFIGS))
def test_json_and_properties_equal(name):
    ours, ref = CONFIGS[name]
    assert ours.to_json() == ref.to_json()
    assert config.ModemConfig.from_json(ours.to_json()) == ours
    assert convert.config_from_jax(ref) == ours
    for p in PROPS:
        assert getattr(ours, p) == getattr(ref, p), p
    np.testing.assert_array_equal(ours.subcarrier_allocation(),
                                  ref.subcarrier_allocation())
    assert ours.replace(pid_max=3).pid_max == 3
    assert ours.validate() is ours
    ref.validate()


@pytest.mark.parametrize("name", list(jpresets.PRESETS))
def test_presets_equal(name):
    cfg, spec = presets.get(name)
    jcfg, jspec = jpresets.get(name)
    assert isinstance(cfg, config.ModemConfig)
    assert isinstance(spec, simulator.ChannelSpec)
    assert cfg.to_json() == jcfg.to_json()
    ours = dataclasses.asdict(spec)
    theirs = dataclasses.asdict(jspec)
    for k, v in ours.items():
        assert theirs[k] == v, k
    # the fields the port's simulator lacks are at their no-op defaults
    for k in set(theirs) - set(ours):
        default = {f.name: f.default for f in dataclasses.fields(jspec)}[k]
        assert theirs[k] == default, k
    assert presets.get(name, pid_max=4)[0].pid_max == 4


# each rule of ModemConfig.validate (rub_mimo_tpu/config.py:312-378)
BAD = {
    "m_not_pow2": dict(num_subcarriers=96),
    "m_small": dict(num_subcarriers=4, cp_len=1),
    "cp_zero": dict(cp_len=0),
    "cp_long": dict(num_subcarriers=64, cp_len=65),
    "streams": dict(num_streams=0),
    "codes": dict(num_access_codes=0),
    "pid": dict(pid_max=0),
    "siso_tx": dict(siso_tx=2),
    "siso_rx": dict(siso_rx=-1),
    "threshold": dict(plateau_threshold=0.0),
    "quorum_range": dict(sync_quorum=3, bit_exact=False),
    "quorum_bit_exact": dict(sync_quorum=1),
    "timing_mode": dict(timing_mode="bogus"),
    "track_mode": dict(track_channel=True, mode="siso"),
    "track_blocks": dict(track_channel=True, pid_max=10),
    "ml_mode": dict(detector="ml", mode="rx_diversity"),
    "sic_track": dict(detector="sic", track_channel=True),
    "ml_space": dict(detector="ml", num_streams=3, modulation="qam64"),
    "smooth_guard": dict(smooth_channel=True, use_all_carriers=False),
    "alamouti_streams": dict(mode="alamouti", num_streams=3),
    "alamouti_odd": dict(mode="alamouti", pid_max=7),
    "sample_rate": dict(sample_rate=0.0),
    "center_frequency": dict(center_frequency=-1.0),
}


def _build(mod, kw):
    kw = dict(kw)
    for key, kind in (("mode", mod.CommMode), ("detector", mod.Detector),
                      ("modulation", mod.Modulation)):
        if key in kw:
            kw[key] = kind(kw[key])
    return mod.ModemConfig(**kw)


@pytest.mark.parametrize("case", list(BAD))
def test_validate_refuses_the_same_configs(case):
    with pytest.raises(ValueError) as theirs:
        _build(jconfig, BAD[case]).validate()
    with pytest.raises(ValueError) as ours:
        _build(config, BAD[case]).validate()
    assert str(ours.value) == str(theirs.value)


def test_entry_points_refuse_a_jax_config():
    jcfg = oracle.TINY
    with pytest.raises(TypeError, match="config_from_jax"):
        rx.make_decoder(jcfg, device="cpu")
    with pytest.raises(TypeError, match="config_from_jax"):
        rx.decode(torch.zeros((2, 64), dtype=torch.complex64), jcfg)
    with pytest.raises(TypeError, match="config_from_jax"):
        simulator.simulate_capture(jcfg, simulator.ChannelSpec(),
                                   device="cpu")
    cfg = convert.config_from_jax(jcfg)
    cap, tx, _ = simulator.simulate_capture(
        cfg, simulator.ChannelSpec(snr_db=35.0, delay=300, seed=3),
        device="cpu")
    r = rx.make_decoder(cfg, device="cpu")(cap)
    with pytest.raises(TypeError, match="config_from_jax"):
        report.score(r, tx, jcfg)
    assert report.score(r, tx, cfg).symbol_error_rate == [0.0, 0.0]
    # the JSON carries the enums by value, whatever the class
    assert json.loads(cfg.to_json())["detector"] == "zf"
