"""``correct`` on the CPU at a tiny size: a sound run of the program is
correct; the control (the plain receiver in bfloat16 in the program's
place) and each fault planted in the timed path are not.

These runs skip the harness's look for a card (``device="cpu"``) and
drive the rest of a run: the pool, the served decode (eager on the CPU),
the window, the readers and the check."""

import time

import pytest
import torch

from portbench import control, harness, program
from portbench.tests import tiny
from rub_mimo_tpu_torch.estimate import ls
from rub_mimo_tpu_torch.kernels import payload_fused
from rub_mimo_tpu_torch.ofdm import fec

SEED = 2**31 + 1234


@pytest.fixture(scope="module")
def reg(tmp_path_factory):
    return tiny.tree(tmp_path_factory.mktemp("tiny"))


def run(reg, cell, make_path=None, seed=SEED):
    """A run whose window serves every capture of the pool twice (on a
    busy CPU a window of a fixed time may judge none the reference
    finds a frame in)."""
    return harness.run_cell(cell, seed, 0.5, False,
                            t_start=time.perf_counter(), registry=reg,
                            device="cpu", make_path=make_path,
                            captures=2 * tiny.TRAFFIC["pool"])


@pytest.mark.parametrize("cell", ["tiny.replay", "tiny.fec"])
def test_a_sound_run_is_correct(reg, cell):
    out = run(reg, cell)
    assert out["correct"], out["checks"]
    assert out["failed"] == 0 and out["attempted"] > 0
    assert list(out)[-1] == "checks"
    assert set(out["metrics"]) == {"iq_rate", "capture_p95_ms", "setup_s"}


@pytest.mark.parametrize("cell", ["tiny.replay", "tiny.fec"])
@pytest.mark.parametrize("seed", [1, 2, 3])
def test_the_control_is_not_correct(reg, cell, seed):
    v = control.control_readings(reg, cell, seed, "cpu")
    assert not v["correct"], v["checks"]
    assert v["checks"]["g_rel_err"]["value"] > v["checks"]["g_rel_err"][
        "limit"]


@pytest.mark.parametrize("cell", ["tiny.replay", "tiny.fec"])
def test_the_float32_witness_is_correct(reg, cell):
    """The plain receiver in float32 in the program's place: what float32
    arithmetic alone does stays inside every limit."""
    v = control.control_readings(reg, cell, SEED, "cpu", "float32")
    assert v["correct"], v["checks"]


def stale(config, device):
    """The served decode returns its first answer again: a replay that
    leaves the graph's outputs as they were."""
    path = program.make(config, device)
    first = []

    def run_(re, im):
        if not first:
            first.append(path(re, im))
        return first[0]
    run_.answer = path.answer
    return run_


def test_a_stale_answer_is_not_correct(reg):
    assert not run(reg, "tiny.replay", make_path=stale)["correct"]


def test_half_the_access_codes_is_not_correct(reg, monkeypatch):
    """The LS estimate averaged over half the codes, as if the other
    half were left out."""
    real = ls.channel_from_ffts

    def half(X, cfg):
        h = cfg.num_access_codes // 2
        return real(X[:h], cfg.replace(num_access_codes=h))
    monkeypatch.setattr(ls, "channel_from_ffts", half)
    out = run(reg, "tiny.replay")
    assert not out["correct"]
    assert out["checks"]["g_rel_err"]["value"] > out["checks"][
        "g_rel_err"]["limit"]


def test_an_altered_decision_is_not_correct(reg, monkeypatch):
    """One decision of K1's (its plain version on the CPU) changed where
    it is made."""
    real = payload_fused.payload_fused_strip

    def altered(*a, **kw):
        sig, data = real(*a, **kw)
        data = data.clone()
        data.view(-1)[7] = (data.view(-1)[7] + 1) % 4
        return sig, data
    monkeypatch.setattr(payload_fused, "payload_fused_strip", altered)
    out = run(reg, "tiny.replay")
    assert not out["correct"]
    assert out["checks"]["data_mismatches"]["value"] > 0


def test_an_altered_message_bit_is_not_correct(reg, monkeypatch):
    real = fec.decode_payload

    def altered(*a, **kw):
        bits = real(*a, **kw).clone()
        bits[0, 11] ^= 1
        return bits
    monkeypatch.setattr(fec, "decode_payload", altered)
    out = run(reg, "tiny.fec")
    assert not out["correct"]
    assert out["checks"]["msg_mismatches"]["value"] > 0


def test_a_shifted_payload_is_not_correct(reg, monkeypatch):
    """The payload window one sample late: every symbol turns a little,
    and the payload start no longer matches."""
    from rub_mimo_tpu_torch.pipeline import rx
    real = rx.window_index
    payload_len = tiny.MODEM["pid_max"] * (tiny.MODEM["num_subcarriers"]
                                           + tiny.MODEM["cp_len"])

    def late(cstart, plen, T, device):
        if plen == payload_len:
            cstart = cstart + 1
        return real(cstart, plen, T, device)
    monkeypatch.setattr(rx, "window_index", late)
    out = run(reg, "tiny.replay")
    assert not out["correct"]
    assert out["checks"]["sig_err_per_cond"]["value"] > out["checks"][
        "sig_err_per_cond"]["limit"]


@pytest.mark.cuda
@pytest.mark.parametrize("cell", ["ref2x2.replay", "fec2x2.replay",
                                  "ref2x2.longcap"])
def test_each_cell_runs_correct_on_the_card(cell):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    out = harness.run_cell(cell, SEED, 1.0, False,
                           t_start=time.perf_counter())
    assert out["correct"], out["checks"]
    assert out["device"]["platform"] == "gpu"
