"""The readings that the check's limits are set from.

    python3 portbench/control.py --workload <cell> --seeds 12 \
        --control-seeds 3 --seconds 2 [--seed <n> ...] [--out readings.jsonl]

in one process on the card: the program's numbers on each of ``--seeds``
seeds (a short window of the cell's own traffic and the run's own
sample, through ``harness.run_cell``), and on the first
``--control-seeds`` seeds those of the configuration's plain receiver
(``Registry.receiver``) put in the program's place: the control,
computed in bfloat16 (its "bfloat16" precision, the step below the
float32 the configurations state), and the witness, computed in
float32 (what float32 arithmetic alone gives), each judged on as many
captures of the pool as a run checks (the traffic's ``check_sample``,
the pool's first).  Each ``--seed`` adds one more seed on which the
program is read.  One JSON line a reading.  The benchmark's own runs
never run this.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
FIRST_SEED = 7_000_000_001


def as_answer(r: dict, md, T: int) -> dict:
    """The plain receiver's answers in the program's form."""
    import torch

    if not r["synced"]:
        return {"synced": False, "sync_index": r["sync_index"],
                "decode_start": 0}
    G = r["G"].new_zeros((md.M, md.S, md.S))
    G[torch.as_tensor(md.occupied, device=G.device)] = r["G"]
    si = r["sync_index"]
    out = {"synced": r["synced"], "sync_index": si,
           "decode_start": r["payload_start"] - min(max(si, 0), T) + md.sym,
           "G": G, "rx_sig": r["rx_sig"], "rx_data": r["rx_data"]}
    if "msg" in r:
        out["msg"] = r["msg"]
    return out


def control_readings(reg, cell_name: str, seed: int, device: str,
                     precision: str = "bfloat16") -> dict:
    """The numbers of the plain receiver in ``precision`` in the
    program's place, on the first ``check_sample`` captures of the
    seed's pool."""
    from portbench import compare, pool as pool_mod

    cell = reg.cell(cell_name)
    config = reg.config(cell["config"])
    traffic = reg.traffic(cell["traffic"])
    rcv = reg.receiver(config)
    md = rcv.Modem(config["modem"])
    limits, coded = config["limits"], bool(config.get("fec"))
    T = traffic["capture_samples"]
    pool = pool_mod.make(md, traffic, seed, device, coded)
    n = min(traffic["check_sample"], pool.re.shape[0])
    kept = []
    for i in range(n):
        r = rcv.receive(pool.capture(i), md, precision,
                        tie_band=limits["tie_band"], coded=coded)
        kept.append((i, i, as_answer(r, md, T)))
    refs = compare.reference_answers(pool, range(n), rcv, md, limits)
    return compare.judge(kept, refs, rcv, md, limits, T, coded)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, default=12)
    ap.add_argument("--control-seeds", type=int, default=3)
    ap.add_argument("--seconds", type=float, default=2.0)
    ap.add_argument("--seed", type=int, action="append", default=[],
                    help="a further seed to read the program on")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    from portbench import harness, program
    from portbench.registry import Registry

    reg = Registry()
    paths = {}

    def cached(config, device):
        if "p" not in paths:
            paths["p"] = program.make(config, device)
        return paths["p"]

    sink = open(args.out, "a") if args.out else None
    n = max(args.seeds, args.control_seeds)
    seeds = [FIRST_SEED + 7919 * k for k in range(n)] + args.seed
    for k, seed in enumerate(seeds):
        rows = []
        if k < args.seeds or k >= n:
            t = time.perf_counter()
            out = harness.run_cell(args.workload, seed, args.seconds, False,
                                   t_start=t, registry=reg,
                                   make_path=cached)
            rows.append({"side": "program", "correct": out["correct"],
                         "attempted": out["attempted"],
                         "checks": out["checks"]})
        if k < args.control_seeds:
            for side, precision in (("control", "bfloat16"),
                                    ("witness", "float32")):
                v = control_readings(reg, args.workload, seed, "cuda",
                                     precision)
                rows.append({"side": side, "correct": v["correct"],
                             "checks": v["checks"]})
        for row in rows:
            line = json.dumps({"workload": args.workload, "seed": seed,
                               **row})
            print(line, flush=True)
            if sink:
                sink.write(line + "\n")
                sink.flush()
    if sink:
        sink.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
