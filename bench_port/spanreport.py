#!/usr/bin/env python3
"""One traced run of a cell, in this process, and what its result line does
not show: the device's idle time in the window by the innermost span of the
program around it, the syncs the program counts by site, how much of the
program's ``update`` and ``predict`` spans their children cover, the
records kept and dropped, and the mean of the benchmark's ``request``
spans.  A program without its own spans (an older commit) gives the
benchmark's numbers alone.

    python3 bench_port/spanreport.py --workload <cell> --seed <n> \\
        --seconds <s> [--out <file.json>]
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time

T_START = time.perf_counter()
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402

from bench_port import harness  # noqa: E402
from bench_port.metrics import _program as P  # noqa: E402

OUTSIDE = "outside program spans"


def idle_by_span(trace, recs: list) -> dict:
    """Seconds of the device's idle time in the window, by the innermost
    program span open at each moment (spans of one thread nest)."""
    events = sorted([(r.t0, 1, -(r.t1 - r.t0), r.name) for r in recs]
                    + [(r.t1, 0, 0, r.name) for r in recs])
    stack, cuts, labels = [], [trace.t0], []
    for t, start, _, name in events:
        t = min(max(t, trace.t0), trace.t1)
        labels.append(stack[-1] if stack else OUTSIDE)
        cuts.append(t)
        if start:
            stack.append(name)
        else:
            stack.pop()
    labels.append(OUTSIDE)
    cuts.append(trace.t1)
    cuts = np.asarray(cuts, np.int64)
    a, b = cuts[:-1], cuts[1:]
    if len(trace.u0):
        busy = trace._busy_until(b) - trace._busy_until(a)
    else:
        busy = np.zeros(len(a), np.int64)
    idle = (b - a) - busy
    out = {}
    for name, s in zip(labels, idle):
        out[name] = out.get(name, 0) + int(s)
    return {k: v / 1e9 for k, v in sorted(out.items(), key=lambda kv: -kv[1])}


def counts_by_site(spans: list, n: int) -> dict:
    tot = {}
    for r in spans:
        for k, c in r.counts.items():
            if k.startswith("sync."):
                tot[k] = tot.get(k, 0) + c
    return {k: v / n for k, v in sorted(tot.items())}


def covered(parents: list, recs: list) -> float:
    """Share of the parents' time that their direct children cover."""
    ids = {r.id for r in parents}
    kids = [r for r in recs if r.parent in ids]
    whole = P.ms(parents)
    return P.ms(kids) / whole if whole else float("nan")


def report(trace) -> dict:
    recs = P.window(trace)
    out = {"records_in_window": len(recs)}
    by_name = {}
    for r in recs:
        by_name[r.name] = by_name.get(r.name, 0) + 1
    out["records_by_name"] = by_name
    out["idle_s_by_innermost_span"] = idle_by_span(trace, recs)
    out["window_s"] = trace.window_s
    out["busy_s"] = trace.busy_s
    its, top = P.in_iterations(recs, "update", "mirror.sync")
    if its:
        out["iterations"] = len(its)
        out["syncs_per_iteration_by_site"] = counts_by_site(top, len(its))
        out["update_covered_by_stage_minibatches_readback"] = covered(
            P.named(recs, "update"), recs)
    calls = [r for r in P.named(recs, "predict") if r.parent is None]
    if calls:
        out["predict_calls"] = len(calls)
        out["predict_covered_by_children"] = covered(calls, recs)
        out["syncs_per_predict_by_site"] = counts_by_site(calls, len(calls))
    reqs = [s for s in trace.spans if s["name"] == "request"]
    if reqs:
        out["request_span_mean_ms"] = (sum(s["t1"] - s["t0"] for s in reqs)
                                       / len(reqs) / 1e6)
    its_b = trace.extra.get("iterations") or []
    if its_b:
        out["bench_iterations"] = len(its_b)
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--out")
    args = ap.parse_args()
    harness.prepare_environment()
    chips = harness.cell_chips(args.workload)
    harness.check_device(chips)
    harness.check_program_source()
    run = harness.Run(args.workload, args.seed, args.seconds, True, T_START)
    extra = {}
    per_layer = run.per_layer

    def capture(trace):
        extra.update(report(trace))
        return per_layer(trace)
    run.per_layer = capture
    out = run.driver.run(run)
    import torch
    from gbrl_tpu_torch.utils import profiling
    extra["dropped"] = getattr(profiling, "dropped", lambda: None)()
    res = harness.result_line(run, out, chips, torch.cuda.get_device_name(0))
    res["spanreport"] = extra
    line = json.dumps(res)
    if args.out:
        with open(args.out, "w") as f:
            f.write(line + "\n")
    print(line, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
