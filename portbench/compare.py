"""How ``correct`` is decided: the program's answers against the plain
receiver's.

For each answer kept from the window (a sample drawn from the seed), the
configuration's plain receiver (``Registry.receiver``: ``reference.rx``
unless the configuration names another; float64) decodes the same
capture, and these numbers are taken over the sample:

  sync_mismatches   answers whose ``synced`` differs from the
                    reference's, or, where both found the frame, whose
                    payload start (the absolute first sample of the
                    payload window: sync_index + decode_start -
                    symbol_len) differs, or whose sync_index differs,
                    unless by one where the reference's metric lies
                    within ``tie_band`` of the threshold near the run
                    starts
  g_rel_err         max |G - G_ref| / max |G_ref| on the occupied carriers
  sig_err_per_cond  max |rx_sig - rx_sig_ref| / rms(rx_sig_ref), over the
                    condition number of G_ref (its worst subcarrier's):
                    zero forcing scales a relative error by up to that
                    factor, and a channel drawn ill-conditioned (as over
                    the air) would otherwise read as a fault
  data_mismatches   decisions that differ where the reference's top-2
                    score margin is above what an equalized symbol within
                    the sig_err_per_cond limit could move it
                    (2 max|c| x the limit x cond x rms)
  msg_mismatches    message bits that differ from the plain back end's
                    (float64 max-log LLRs, deinterleave, the Viterbi at
                    the receiver's windows) decoding the answer's own
                    equalized symbols (coded configurations), in the
                    Viterbi windows whose tie margin (reference.viterbi)
                    is above ``viterbi_tie_band``.  The symbols are
                    judged above against the reference's; this number
                    judges the step from symbols to bits.  Where a
                    decode fails (a channel so ill-conditioned that most
                    bits are wrong), rounding alone, float32 against
                    float64, moves the Viterbi's survivors: in the
                    symbols, by hundreds of bits; in the step from the
                    same symbols, in the windows whose traced path won
                    a comparison by less than rounding

Where the reference finds no frame (a channel that fades S0 at an
antenna), only ``synced`` is judged: both sides then decode noise, and
nothing else of the answer means anything.  Where the reference finds
one and the program does not, that is a sync mismatch and the rest of
the answer is not judged either.

Each number has a limit in the config's ``limits``; the run is correct
when every number is at or under its limit.  The limits and the readings
they were set from are in PERF.md.
"""

from __future__ import annotations

import numpy as np
import torch

from portbench.registry import Receiver

NUMBERS = ("sync_mismatches", "g_rel_err", "sig_err_per_cond",
           "data_mismatches", "msg_mismatches")


MSG_BLOCK = 8  # answers whose symbols one plain Viterbi call decodes


def judge_one(got: dict, want: dict, rcv: Receiver, md, limits: dict,
              T: int) -> dict:
    """The numbers of one answer against the reference's (md: the
    receiver's Modem of the configuration, T: the capture's length), but
    msg_mismatches; a relative error is 0.0 where nothing is judged."""
    out = {"sync_mismatches": int(bool(got["synced"]) != want["synced"]),
           "g_rel_err": 0.0, "sig_err_per_cond": 0.0, "data_mismatches": 0}
    if not (want["synced"] and bool(got["synced"])):
        return out
    si = int(got["sync_index"])
    # decode_start counts from one symbol after the region's start
    start = min(max(si, 0), T) + int(got["decode_start"]) - md.sym
    out["sync_mismatches"] = int(
        start != want["payload_start"]
        or abs(si - want["sync_index"]) > (1 if want["near_tie"] else 0))
    dev = want["G"].device
    occ = torch.as_tensor(md.occupied, device=dev)
    G = got["G"].to(dev)[occ].to(want["G"].dtype)
    out["g_rel_err"] = float((G - want["G"]).abs().max()
                             / want["G"].abs().max())
    sig = got["rx_sig"].to(dev).to(want["rx_sig"].dtype)
    rms = float(want["rx_sig"].abs().pow(2).mean().sqrt())
    sig_err = float((sig - want["rx_sig"]).abs().max()) / rms
    out["sig_err_per_cond"] = sig_err / want["cond"]
    c_max = float(np.abs(rcv.points(md.modulation)).max())
    band = 2 * c_max * limits["sig_err_per_cond"] * want["cond"] * rms
    differ = got["rx_data"].to(dev) != want["rx_data"]
    out["data_mismatches"] = int((differ & (want["margin"] > band)).sum())
    return out


def message_mismatches(answers: list, rcv: Receiver, md, limits: dict,
                       device) -> list:
    """msg_mismatches of each answer: its bits against the plain back end
    decoding its own equalized symbols, in the windows whose tie margin
    is above viterbi_tie_band; MSG_BLOCK answers a decode."""
    p = rcv.Precision("float64")
    out = []
    for a in range(0, len(answers), MSG_BLOCK):
        block = answers[a:a + MSG_BLOCK]
        y = torch.cat([g["rx_sig"].to(device).to(torch.complex128)
                       for g in block])
        msg, ties = rcv.decode_bits(y, md, p)
        got = torch.cat([g["msg"].to(device) for g in block])
        differ = (got != msg) & (ties > limits["viterbi_tie_band"])
        out += [int(v) for v in differ.reshape(len(block), -1).sum(-1)]
    return out


def reference_answers(pool, indices, rcv: Receiver, md, limits: dict,
                      precision: str = "float64") -> dict:
    """pool index -> the plain receiver's answers, one capture at a time."""
    return {i: rcv.receive(pool.capture(i), md, precision,
                           tie_band=limits["tie_band"])
            for i in sorted(set(indices))}


def judge(kept: list, refs: dict, rcv: Receiver, md, limits: dict, T: int,
          coded: bool = False) -> dict:
    """The numbers over the kept answers [(request, pool index, answer)]:
    counts summed, relative errors their maximum; with each answer's
    verdict."""
    ones = [judge_one(got, refs[i], rcv, md, limits, T)
            for _, i, got in kept]
    if coded:
        both = [k for k, (_, i, got) in enumerate(kept)
                if refs[i]["synced"] and bool(got["synced"])]
        for one in ones:
            one["msg_mismatches"] = 0
        if both:
            device = refs[kept[both[0]][1]]["G"].device
            counts = message_mismatches([kept[k][2] for k in both], rcv,
                                        md, limits, device)
            for k, v in zip(both, counts):
                ones[k]["msg_mismatches"] = v
    total = {}
    failed = 0
    for one in ones:
        failed += any(v > limits[k] for k, v in one.items())
        for k, v in one.items():
            total[k] = (total.get(k, 0) + v if k.endswith("mismatches")
                        else max(total.get(k, 0.0), v))
    checks = {k: {"value": total[k], "limit": limits[k]}
              for k in NUMBERS if k in total}
    return {"checks": checks, "failed": failed,
            "correct": bool(kept) and all(
                c["value"] <= c["limit"] for c in checks.values())}
