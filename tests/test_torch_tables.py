"""Port parity: the deterministic tables (subcarrier allocation, LFSR
streams, preambles, constellations) equal the JAX package's bitwise, and
the torch modulate/demodulate match the JAX ones."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from rub_mimo_tpu.config import ModemConfig, Modulation, tiny_config
from rub_mimo_tpu.ofdm import constellation as jconst
from rub_mimo_tpu.ofdm import lfsr as jlfsr
from rub_mimo_tpu.ofdm import preamble as jpre
from rub_mimo_tpu.ofdm import sctype as jsct
from rub_mimo_tpu_torch import Modulation as PModulation
from rub_mimo_tpu_torch.ofdm import constellation, lfsr, preamble, sctype
import torch_oracle as oracle


def pmod(mod: Modulation) -> PModulation:
    """The port's Modulation of the same value."""
    return PModulation(mod.value)


@pytest.mark.parametrize("M,use_all,add_null", [
    (64, True, True), (64, False, True), (2048, False, True),
    (2048, False, False), (32, False, True)])
def test_sctype_allocation_equal(M, use_all, add_null):
    cfg = ModemConfig(num_subcarriers=M, cp_len=M // 8,
                      use_all_carriers=use_all, add_null_carriers=add_null)
    ours = sctype.allocation(cfg)
    ref = jsct.init_default_sctype(M, use_all_carriers=use_all,
                                   add_null_carriers=add_null)
    np.testing.assert_array_equal(ours, ref)
    assert sctype.m_occupied(cfg) == cfg.M_occupied
    assert oracle.pcfg(cfg).M_occupied == cfg.M_occupied
    np.testing.assert_array_equal(oracle.pcfg(cfg).subcarrier_allocation(),
                                  ref)
    np.testing.assert_array_equal(sctype.occupied_indices(ours),
                                  jsct.occupied_indices(ref))
    assert sctype.validate_sctype(ours) == jsct.validate_sctype(ref)


def test_lfsr_streams_equal():
    for m, g in ((12, 0o10123), (13, 0o20033), (13, 0o20047)):
        a = lfsr.MSequence(m, g, 1)
        b = jlfsr.MSequence(m, g, 1)
        np.testing.assert_array_equal(a.generate_bits(5000),
                                      b.generate_bits(5000))
        assert [a.generate_symbol(5) for _ in range(50)] == [
            b.generate_symbol(5) for _ in range(50)]
    for S in (2, 4):
        cfg = tiny_config(num_streams=S)
        assert lfsr.lfsr_polys_for_streams(cfg) == \
            jlfsr.lfsr_polys_for_streams(cfg)


@pytest.mark.parametrize("cfg", [
    tiny_config(), tiny_config(num_streams=4), tiny_config(s1_qpsk=True),
    tiny_config(use_all_carriers=False), oracle.MID],
    ids=["tiny", "tiny4x4", "s1qpsk", "guard", "mid"])
def test_preamble_tables_equal(cfg):
    ours, ref = preamble.tables(oracle.pcfg(cfg)), jpre.tables(cfg)
    for field in ("S0", "s0", "S1", "s1", "s0_unnormalized",
                  "s1_unnormalized"):
        a, b = getattr(ours, field), getattr(ref, field)
        assert a.dtype == b.dtype, field
        np.testing.assert_array_equal(a, b, err_msg=field)
    assert ours.M_S0 == ref.M_S0


@pytest.mark.parametrize("mod", list(Modulation))
def test_constellation_table_equal(mod):
    np.testing.assert_array_equal(constellation.table(pmod(mod)),
                                  jconst.table(mod))


def test_arb32opt_override_equal():
    pts = (np.exp(2j * np.pi * np.arange(32) / 32)
           * (1 + 0.1 * (np.arange(32) % 3))).astype(np.complex64)
    try:
        constellation.set_arb32opt_table(pts)
        jconst.set_arb32opt_table(pts)
        np.testing.assert_array_equal(
            constellation.table(PModulation.ARB32OPT),
            jconst.table(Modulation.ARB32OPT))
        np.testing.assert_array_equal(
            constellation.table(PModulation.ARB32OPT), pts)
    finally:
        constellation.set_arb32opt_table(None)
        jconst.set_arb32opt_table(None)
    np.testing.assert_array_equal(constellation.table(PModulation.ARB32OPT),
                                  jconst.table(Modulation.ARB32OPT))


@pytest.mark.parametrize("mod", [Modulation.QPSK, Modulation.QAM16,
                                 Modulation.ARB32OPT, Modulation.QAM256])
def test_modulate_demodulate_match_jax(mod):
    rng = np.random.default_rng(11)
    sym = rng.integers(0, mod.arity, size=(2, 500)).astype(np.int32)
    np.testing.assert_array_equal(
        oracle.n(constellation.modulate(torch.as_tensor(sym), pmod(mod))),
        np.asarray(jconst.modulate(jnp.asarray(sym), mod)))
    y = ((rng.standard_normal((3, 400)) + 1j * rng.standard_normal((3, 400)))
         * 0.8).astype(np.complex64)
    got = oracle.n(constellation.demodulate(torch.as_tensor(y), pmod(mod)))
    ref = np.asarray(jconst.demodulate(jnp.asarray(y), mod))
    assert got.dtype == np.int32 and got.shape == y.shape
    np.testing.assert_array_equal(got, ref)


def test_hard_demap_first_max_wins():
    # a point exactly between two table entries: the lower index wins
    pts = np.array([1 + 0j, -1 + 0j, 1j], dtype=np.complex64)
    y = torch.tensor([0j, 0.5 + 0.5j], dtype=torch.complex64)
    assert constellation.hard_demap(y, pts).tolist() == [0, 0]
