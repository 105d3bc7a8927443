"""The benchmark's frozen generator and plain receiver on the CPU.

The generator is held equal to the program's own simulator and encoder
(the tests may import the program; the generator and the reference may
not), and the plain receiver decodes the generator's captures: the
payload where the frame put it, every symbol and message bit right."""

import numpy as np
import pytest
import torch

from portbench import pool as pool_mod
from portbench.reference import rx, tx, viterbi
from portbench.reference.tables import Modem, points, preambles
from portbench.tests import tiny
from rub_mimo_tpu_torch import config as pconfig
from rub_mimo_tpu_torch.io import simulator
from rub_mimo_tpu_torch.ofdm import constellation, fec, framegen, preamble

MODS = ("qpsk", "qam16", "arb32opt")


def modem(mod, **kw):
    return dict(tiny.MODEM, modulation=mod, mode="rx_zf", detector="zf",
                bit_exact=False, **kw)


def port_cfg(mod):
    return pconfig.ModemConfig(**dict(tiny.MODEM, bit_exact=False,
                                      modulation=pconfig.Modulation(mod)))


@pytest.mark.parametrize("mod", MODS + ("bpsk", "qam64", "qam256"))
def test_tables_equal_the_programs(mod):
    want = constellation.table(pconfig.Modulation(mod))
    assert np.array_equal(points(mod), want)


@pytest.mark.parametrize("M", [64, 2048])
def test_preambles_equal_the_programs(M):
    mod = dict(tiny.MODEM, num_subcarriers=M, modulation="qpsk",
               bit_exact=False)
    got = preambles(Modem(mod))
    want = preamble.tables(pconfig.ModemConfig(
        **dict(mod, modulation=pconfig.Modulation.QPSK)))
    for k in ("S0", "S1", "s0", "s1"):
        assert np.array_equal(got[k].astype(np.complex64), getattr(want, k))


@pytest.mark.parametrize("mod", MODS)
@pytest.mark.parametrize("seed", [3, 2**31 + 77])
def test_capture_equals_simulate_capture(mod, seed):
    cfg = port_cfg(mod)
    spec = simulator.ChannelSpec(snr_db=30.0, delay=321, trailing=555,
                                 seed=seed)
    want, tx_data, h = simulator.simulate_capture(cfg, spec,
                                                  payload_seed=seed + 5,
                                                  device="cpu")
    md = Modem(modem(mod))
    h2 = tx.draw_channel(np.random.default_rng(seed), md.S)
    assert np.array_equal(h, h2)
    gen = torch.Generator().manual_seed(seed + 1)
    got = tx.apply_channel(tx.transmit(md, torch.as_tensor(tx_data)), h2,
                           321, 555, 30.0, gen)
    assert torch.equal(got, want)


def test_encoder_equals_encode_payload():
    cfg = port_cfg("qam16")
    msg, want = fec.encode_payload(cfg, 9)
    got = tx.encode(Modem(modem("qam16")), torch.as_tensor(msg))
    assert np.array_equal(got.numpy(), want)
    assert msg.shape[1] == tx.message_bits(Modem(modem("qam16")))


def test_sync_words_equal_the_programs():
    md = Modem(modem("qpsk"))
    assert np.array_equal(tx.sync_words(md, "cpu").numpy(),
                          framegen.write_sync_words(port_cfg("qpsk")))


@pytest.mark.parametrize("mod,coded", [("qpsk", False), ("arb32opt", False),
                                       ("qam16", True)])
def test_reference_decodes_the_generators_captures(mod, coded):
    md = Modem(modem(mod))
    pool = pool_mod.make(md, tiny.TRAFFIC, 2**31 + 3, "cpu", coded)
    for i, d in enumerate(pool.delays):
        r = rx.receive(pool.capture(i), md, coded=coded)
        assert r["synced"]
        # the frame's first sample is the delay; its payload follows the
        # n_seq sync symbols
        assert r["payload_start"] == d + md.n_seq * md.sym
        assert d <= r["sync_index"] < d + md.sym
        if coded:
            assert torch.equal(r["msg"], pool.msg[i])


def test_reference_symbols_are_the_transmitted_ones():
    md = Modem(modem("qpsk"))
    traffic = dict(tiny.TRAFFIC, pool=1)
    gen = torch.Generator().manual_seed(4)
    data = torch.randint(0, 4, (2, md.n_sym * md.m_occ), generator=gen,
                         dtype=torch.int32)
    h = tx.draw_channel(np.random.default_rng(4), 2)
    x = tx.apply_channel(tx.transmit(md, data), h, 500,
                         traffic["capture_samples"] - md.frame_len - 500,
                         30.0, gen)
    assert torch.equal(rx.receive(x, md)["rx_data"], data)


def test_every_seed_gets_the_same_delays_in_another_order():
    d = pool_mod.delays(np.random.default_rng(1), 1000, 100000, 32)
    width = (100000 - 1000) / 32
    strata = np.sort(((d - 1000) // width).astype(int))
    assert np.array_equal(strata, np.arange(32))
    e = pool_mod.delays(np.random.default_rng(2), 1000, 100000, 32)
    assert not np.array_equal(d, e)
    assert np.array_equal(np.sort(d), np.sort(e))


def test_pool_refuses_frames_that_do_not_fit():
    md = Modem(modem("qpsk"))
    with pytest.raises(ValueError):
        pool_mod.check(md, dict(tiny.TRAFFIC, delay=[0, 3000]))


def test_the_reference_refuses_what_it_does_not_decode():
    for bad in (dict(detector="mmse"), dict(use_all_carriers=False),
                dict(sync_quorum=1), dict(correct_cfo=True),
                dict(bit_exact=True)):
        with pytest.raises(ValueError):
            Modem(dict(modem("qpsk"), **bad))


@pytest.mark.parametrize("steps", [3000, 5 * 4096 + 77])
def test_the_reference_viterbi_cuts_where_the_program_does(steps):
    """On LLRs so noisy that survivor paths do not merge within a margin,
    the plain Viterbi gives the program's bits: one scan for a short
    codeword, windows of 4096 steps with 128 of margin for a long one
    (where a cut at other places gives other bits)."""
    gen = torch.Generator().manual_seed(steps)
    n = steps - tx.TAIL
    bits = torch.randint(0, 2, (2, n), generator=gen, dtype=torch.int32)
    coded = fec.conv_encode(bits)
    llrs = (1.0 - 2.0 * coded) + 2.0 * torch.randn(coded.shape,
                                                   generator=gen)
    llrs = llrs.to(torch.float32)
    window = 4096 if steps > 4 * 4096 else None
    want = fec.viterbi_decode(llrs, window=window, margin=128)
    got, ties = viterbi.decode(llrs.to(torch.float64).reshape(2, steps, 2))
    assert torch.equal(got[:, :n], want)
    assert ties.shape == got.shape and bool((ties >= 0).all())
    assert (want != bits).float().mean() > 0.05  # the decode fails
    if window is not None:
        other = fec.viterbi_decode(llrs, window=2048, margin=96)
        assert not torch.equal(other, want)


def test_a_window_that_the_llrs_leave_open_has_no_tie_margin():
    """Certain LLRs leave one path far ahead of every other; LLRs of 0
    tie every comparison, so no bit of that window is determined."""
    gen = torch.Generator().manual_seed(5)
    bits = torch.randint(0, 2, (1, 500), generator=gen, dtype=torch.int32)
    sure = 4.0 * (1.0 - 2.0 * fec.conv_encode(bits)).to(torch.float64)
    pairs = torch.stack([sure, torch.zeros_like(sure)]).reshape(2, -1, 2)
    got, ties = viterbi.decode(pairs)
    assert torch.equal(got[0, :500], bits[0])
    assert float(ties[0].min()) > 1.0 and float(ties[1].max()) == 0.0
