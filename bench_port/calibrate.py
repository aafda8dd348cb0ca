#!/usr/bin/env python3
"""Readings that the limits of a cell's check are set from: the program's
over many seeds, the control's (the plain reference in the program's place,
in the next precision below the configuration's) and the planted faults'.
The benchmark's own runs do not run this.

    python3 bench_port/calibrate.py --workload <cell> --first <seed>

One JSON line per seed and side on standard output, for ``SEEDS`` seeds
from ``--first`` on.  Training cells run one unit per seed, the window's
first, and read it as a run does; serving cells run a window of
``SECONDS`` at the cell's load per seed.
"""
import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from bench_port import harness  # noqa: E402

# the nearest precision below the one a configuration states
CONTROL = {"float64": "float32", "float32": "bfloat16"}
SEEDS = 12
SECONDS = 3.0


def train(r, dtype) -> list:
    from bench_port.traffic import learn
    k = r.mix["check_steps"]
    r.seconds = 0.0                       # the checked unit alone
    out = r.driver.run(r)
    seed = learn.unit_seeds(r.seed, 2)[1]
    rows = [("program", out["numbers"])]
    for side, dt, fault in (("control", dtype, ""),
                            ("half_batch", None, "half_batch"),
                            ("unchanged", None, "unchanged")):
        import torch
        stand = r.reference.stand_in(r.cfg, seed, k, dt or torch.float64,
                                     r.device, fault)
        rows.append((side, r.reference.train_check(stand, r.cfg, seed, k,
                                                   r.device)))
    return rows


def serve(r, dtype) -> list:
    from bench_port.traffic import serve as drv
    out = drv.run(r)
    sv = out["served"]
    rows = [("program", out["numbers"])]
    ens = drv.served_ensemble(r, sv["arrays"])
    pick = drv.sample_requests(r, len(sv["outs"]))
    ctrl = [None] * len(sv["outs"])
    for i in pick:
        ctrl[i] = r.reference.serve_outputs(r.cfg, sv["obs"][i], ens, dtype,
                                            r.device)
    rows.append(("control", {"output_gap": drv.output_gap(
        r, sv["arrays"], sv["obs"], ctrl)}))
    # an answer altered where it is produced: one output of one request
    bad = list(sv["outs"])
    i = pick[len(pick) // 2]
    bad[i] = tuple(o.copy() for o in bad[i])
    bad[i][0].reshape(-1)[0] += 1.0
    rows.append(("answer_altered", {"output_gap": drv.output_gap(
        r, sv["arrays"], sv["obs"], bad)}))
    return rows


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--workload", required=True)
    ap.add_argument("--first", type=int, required=True)
    a = ap.parse_args()
    harness.prepare_environment()
    try:
        harness.check_device(harness.cell_chips(a.workload))
    except harness.BenchError as e:
        print(f"calibrate: {e}", file=sys.stderr)
        return 2
    import torch
    for n in range(SEEDS):
        seed = a.first + 7919 * n
        r = harness.Run(a.workload, seed, SECONDS, False,
                        time.perf_counter())
        dtype = getattr(torch, CONTROL[r.cfg["precision"]])
        kind = train if r.mix["driver"] == "learn" else serve
        for side, numbers in kind(r, dtype):
            print(json.dumps(dict(workload=a.workload, seed=seed, side=side,
                                  **numbers)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
