"""The training driver: a closed loop of whole training runs ("units"),
one after another, each a fresh agent whose ``learn`` completes.

Set-up warms up: an agent on a seed that no unit uses runs
``warmup_iterations`` iterations through ``learn``, the call the window
makes.  The window then builds fresh units until the deadline; the unit
the deadline falls in is finished and counted.  The rate is every env
step of every unit over all the time from the window's start to the last
unit's end.  A unit is one whole ``learn`` call, which resets its envs and
plans its trees' capacity from its total, so it cannot be split between
set-up and the window: the check reads the window's first unit itself,
once the window has closed, and the plain reference replays that unit's
first steps and walks the trees that served its last rollout."""
from __future__ import annotations

import contextlib
import gc
import math
import time

import numpy as np

from .. import hoststats, peaks, tracing
from ..device import free, memory_peak, profiler, sync

# spans of the RL loop's layer and of the fused update's
ROLES = {"rollout": "rollout", "replay": "rollout", "update": "update",
         "sync": "update"}


def unit_seeds(seed: int, n: int) -> list:
    """Seeds of the run's units, drawn from the run's seed: the first is
    the warm-up's."""
    return [int(s) for s in np.random.SeedSequence(seed).generate_state(
        n, dtype=np.uint32)]


def warm_up(r) -> list:
    """Run the warm-up agent; returns the run's unit seeds."""
    seeds = unit_seeds(r.seed, 4096)
    warm = r.agent.build(r.cfg, r.device)
    warm.learn(r.mix["warmup_iterations"] * r.agent.iteration_steps(r.cfg),
               seed=seeds[0])
    del warm
    gc.collect()
    sync(r.device)
    return seeds


def run(r) -> dict:
    cfg, mix, agent_mod = r.cfg, r.mix, r.agent
    k = mix["check_steps"]
    total = cfg["total_timesteps"]
    seeds = warm_up(r)

    spans = prof = None
    if r.trace:
        spans = tracing.Spans()
        for module, attr, name in agent_mod.SPANS:
            spans.wrap(module, attr, name,
                       None if name == "sync" else agent_mod.span_context)
        prof = profiler(r.device)
        prof.start()

    steps = attempted = failed = 0
    units = []
    checked = None
    host = hoststats.Window()
    t0 = time.perf_counter()
    w0 = time.time_ns()
    deadline = t0 + r.seconds
    with (spans.count_syncs(r.device) if spans else contextlib.nullcontext()):
        while checked is None or time.perf_counter() < deadline:
            attempted += 1
            m0 = host.mark()
            a = agent_mod.build(cfg, r.device)
            try:
                a.learn(total, seed=seeds[attempted])
                steps += a.curve[-1]["steps"]
                if not agent_mod.finite(a):
                    failed += 1
            except Exception as e:            # a unit that raises fails
                r.log(f"unit {attempted} raised {e!r}")
                failed += 1
            if checked is None:
                checked = a
            del a
            units.append([y - x for x, y in zip(m0, host.mark())])
        sync(r.device)
    t1 = time.perf_counter()
    w1 = time.time_ns()
    host.close()
    peak = memory_peak(r.device)
    out = dict(attempted=attempted, failed=failed, memory_peak_bytes=peak)
    r.log(f"{attempted} units, {steps} env steps in {t1 - t0:.3f} s; "
          f"units {' '.join(f'{u[0]:.3f}' for u in units)} s")
    r.log("units' cpu " + " ".join(f"{u[1]:.3f}" for u in units)
          + " s, gc " + " ".join(f"{u[2]:.4f}" for u in units) + " s")
    r.log(f"host {host.report()}")
    if r.trace:
        prof.stop()
        spans.unwrap()
        trace = tracing.Trace((w0, w1), spans.records,
                              tracing.device_events(prof),
                              dict(iterations=iterations(spans.records, r)))
        del prof
        out.update(metrics=r.per_layer(trace), busy_s=trace.busy_s,
                   window_s=trace.window_s,
                   breakdown=dict(device_ops=trace.top_ops(),
                                  idle_gaps=trace.idle_gaps()))
    else:
        out["metrics"] = {
            "env_steps_per_s": {"value": steps / (t1 - t0),
                                "unit": "steps/s"},
            "setup_s": {"value": t0 - r.t_start, "unit": "s"}}
    out["numbers"] = check(r, checked, seeds[1])
    return out


def check(r, checked, seed: int) -> dict:
    """Read the checked unit, free the program's state, then judge what
    was read with the plain reference; a unit that cannot be read reads
    as infinitely far off."""
    k = r.mix["check_steps"]
    try:
        X1 = r.reference.inputs(r.cfg, seed)[0]["obs"]
        readings = r.agent.readings(checked, r.cfg, X1, k)
    except Exception as e:
        r.log(f"the checked unit cannot be read: {e!r}")
        readings = None
    del checked
    gc.collect()
    free(r.device)
    if readings is None:
        return {name: math.inf for name in r.limits}
    return r.reference.train_check(readings, r.cfg, seed, k, r.device)


def iterations(records: list, r) -> list:
    """The traced window's iterations: from one rollout span to the next,
    each with its layers' host time, the syncs, the trees fit, the intervals
    of its update spans and the least time of its work."""
    top = sorted((s for s in records if s["depth"] == 0),
                 key=lambda s: s["t0"])
    out = []
    for s in top:
        if s["name"] == "rollout" or not out:
            out.append(dict(rollout_s=0.0, update_s=0.0, syncs=0, trees=0,
                            update_iv=[], t0=s["t0"], t1=s["t1"],
                            work={"rollout": [0, 0], "update": [0, 0]}))
        it = out[-1]
        role = ROLES[s["name"]]
        it[role + "_s"] += (s["t1"] - s["t0"]) / 1e9
        it["t1"] = max(it["t1"], s["t1"])
        ops, byt = r.agent.phase_work(r.cfg, s["name"], s["ctx"])
        it["work"][role][0] += ops
        it["work"][role][1] += byt
        if role == "update":
            it["syncs"] += s["syncs"]
            it["update_iv"].append((s["t0"], s["t1"]))
        if s["name"] == "update":
            it["trees"] += r.agent.trees_added(r.cfg)
    for it in out:
        it["least_s"] = {k: peaks.least_seconds(*v)
                         for k, v in it["work"].items()}
    return out

