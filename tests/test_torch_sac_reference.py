"""The port's fused SAC step against the benchmark's plain reference
(bench_port/reference/sac.py) on the CPU, and a traced rehearsal of the
``sac_pendulum.train`` cell.

The step: seeded random actor and critic ensembles of 5-20 trees, 32
rows, F = 3, depth 3, each critic's target a prefix shorter than its
ensemble; ``sac_train_step`` against the reference's float64 step with the
same draws, for the linear and the quadratic Q-forms: the target-prefix
sums, the losses, and the new trees (structure and leaf values, the means
of the clipped gradients).  The numbers are held to the cell's own limits
(bench_port/workloads/sac_pendulum.train.json); the reference with its
targets over the whole ensemble fails ``target_gap``."""
import copy
import json
import math
import os
import sys
import time

import numpy as np
import pytest
import torch

from gbrl_tpu_torch.ensemble import ensure_capacity
from gbrl_tpu_torch.ops.boosting import predict_sgd
from gbrl_tpu_torch.rl import jit_sac
from gbrl_tpu_torch.rl.sac import SAC
from gbrl_tpu_torch.utils import profiling

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from bench_port import compare, envs, harness, tracing  # noqa: E402
from bench_port.agents import heap_arrays  # noqa: E402
from bench_port.reference import sac as ref  # noqa: E402

CELL = "sac_pendulum.train"
LIMITS = harness.load_json("workloads", CELL)["limits"]
N, A = 32, 1
TREES = {"critic0": 9, "critic1": 17, "actor": 12}
PREFIXES = [5, 10]
ALPHA = 0.07


def small_cfg(qtype: str) -> dict:
    cfg = copy.deepcopy(harness.load_json("configs", "sac_pendulum"))
    cfg["tree_struct"].update(max_depth=3, n_bins=16)
    cfg["hyper"].update(q_func_type=qtype, max_grad_norm=1.0, schedule_T=40)
    return cfg


def grown_agent(cfg: dict, rng):
    """A port SAC whose learners took TREES[role] boosting steps on random
    gradients, the critics with a value bias."""
    h = cfg["hyper"]
    algo = SAC(envs.make("pendulum", 2), tree_struct=dict(cfg["tree_struct"]),
               params=dict(cfg["params"]), actor_lr=h["actor_lr"],
               critic_lr=h["critic_lr"], bias_lr=h["bias_lr"],
               schedule_T=h["schedule_T"], q_func_type=h["q_func_type"],
               max_grad_norm=h["max_grad_norm"], device="cpu")
    roles = dict(zip(("critic0", "critic1", "actor"),
                     [c.learner for c in algo.critics] + [algo.actor.learner]))
    for role, lr in roles.items():
        if role != "actor":
            b = lr.get_bias().copy()
            b[-1] = -5.0
            lr.set_bias(b)
        for _ in range(TREES[role]):
            X = rng.normal(size=(64, 3)).astype(np.float32)
            lr.step(X, rng.normal(size=(64, lr.output_dim)).astype(np.float32))
        lr.ens = ensure_capacity(lr.ens, TREES[role] + 1)
    return algo, roles


def batch(rng):
    th = rng.uniform(-np.pi, np.pi, N)
    obs = np.stack([np.cos(th), np.sin(th), rng.normal(size=N)], 1)
    nth = th + rng.normal(size=N) * 0.1
    nobs = np.stack([np.cos(nth), np.sin(nth), rng.normal(size=N)], 1)
    return dict(obs=obs.astype(np.float32), nobs=nobs.astype(np.float32),
                act=rng.uniform(-1, 1, (N, A)).astype(np.float32),
                rew=(rng.normal(size=N) - 3.0).astype(np.float32),
                done=(rng.random(N) < 0.2).astype(np.float32),
                disc=(0.9 ** rng.integers(1, 4, N)).astype(np.float32))


def reference_learners(cfg: dict, roles: dict):
    """The reference's learners holding the program's trees."""
    out = {}
    for role, lr in roles.items():
        arrs = heap_arrays(lr, TREES[role])
        ln = ref.Learner(cfg, "actor" if role == "actor" else "critic",
                         arrs["bias"], torch.float64, "cpu")
        ln.fitted = [{k: torch.as_tensor(arrs[k][t]) for k in
                      ("feat", "thr", "is_split", "leaf_values")}
                     for t in range(TREES[role])]
        out[role] = ln
    return out


def reference_step(cfg, roles, b, eps, follow, fault=""):
    lrs = reference_learners(cfg, roles)
    rb = dict(obs=b["obs"], nobs=b["nobs"],
              **{k: torch.as_tensor(b[k], dtype=torch.float64)
                 for k in ("act", "rew", "done", "disc")})
    return ref.gradient_step(cfg, lrs["actor"], [lrs["critic0"],
                                                 lrs["critic1"]],
                             PREFIXES, rb, eps[0], eps[1], ALPHA, 0, fault,
                             follow)


@pytest.mark.parametrize("qtype", ["linear", "quadratic"])
def test_fused_step_matches_the_reference(qtype):
    cfg = small_cfg(qtype)
    rng = np.random.default_rng(18)
    algo, roles = grown_agent(cfg, rng)
    b = batch(rng)
    gen = torch.Generator().manual_seed(5)
    eps = [torch.randn((N, A), generator=gen) for _ in range(2)]
    t = {k: torch.as_tensor(v) for k, v in b.items()}
    alr, clr = algo.actor.learner, algo.critics[0].learner
    hp = jit_sac.SACHyper(act_dim=A, q_func_type=qtype, max_grad_norm=1.0)
    new_actor, new_critics, stats = jit_sac.sac_train_step(
        alr.cfg, clr.cfg, hp, (alr.specs, clr.specs), alr.ens,
        tuple(c.learner.ens for c in algo.critics),
        torch.tensor(PREFIXES, dtype=torch.int32), t["obs"], t["act"],
        t["rew"], t["nobs"], t["done"], t["disc"], torch.tensor(ALPHA),
        torch.ones(3), eps[0], eps[1])
    new = dict(zip(("critic0", "critic1", "actor"),
                   list(new_critics) + [new_actor]))
    follow = {role: [{f: getattr(new[role], f)[TREES[role]].numpy()
                      for f in ("feat", "thr", "is_split")}]
              for role in new}
    out = reference_step(cfg, roles, b, eps, follow)

    # the targets: each critic's sums up to its prefix, shorter than its
    # ensemble, over the next observations
    sums = [predict_sgd(c.learner.cfg, c.learner.ens, t["nobs"],
                        c.learner.specs, 0, torch.tensor(p, dtype=torch.int32))
            .numpy() for c, p in zip(algo.critics, PREFIXES)]
    assert all(p < TREES[f"critic{i}"] for i, p in enumerate(PREFIXES))
    assert max(compare.forward_gap(s, r) for s, r in zip(
        sums, out["targets"])) <= LIMITS["target_gap"]
    prog = [float(stats["critic_loss"]), float(stats["actor_loss"])]
    want = [float(np.mean(out["losses"][:2])), float(out["losses"][2])]
    assert compare.loss_gap(prog, want) <= LIMITS["loss_gap"]
    assert abs(float(stats["logp_mean"]) - out["logp_mean"]) <= 1e-5 * max(
        1.0, abs(out["logp_mean"]))
    for role, ens in new.items():
        n = TREES[role]
        tree = out["trees"][role]
        assert int(ens.n_trees) == n + 1
        np.testing.assert_array_equal(ens.feat[n].numpy(),
                                      tree["feat"].numpy())
        np.testing.assert_array_equal(ens.thr[n].numpy(), tree["thr"].numpy())
        np.testing.assert_array_equal(ens.is_split[n].numpy(),
                                      tree["is_split"].numpy())
        # leaf values: the means of the clipped gradients, per block
        gap = compare.forward_gap(ens.leaf_values[n].numpy(),
                                  tree["leaf_values"].numpy())
        assert gap <= LIMITS["grad_gap"], (role, gap)
        assert torch.all(out["grads"][role].norm(dim=1) <= math.sqrt(2) + 1e-9)

    # the planted fault: targets over every critic tree
    bad = reference_step(cfg, roles, b, eps, follow, "whole_target")
    gap = max(compare.forward_gap(s, r) for s, r in zip(sums,
                                                        bad["targets"]))
    assert gap > LIMITS["target_gap"]


def test_traced_rehearsal_reads_the_cells_train_metrics(monkeypatch):
    """A traced run of the cell at a small size through the harness: the
    program's spans nest as the training cells' readers expect, the
    ``sync.<site>`` counters (counted here as on the card) give 8 a train
    event, the check's numbers are within the cell's limits, and every
    per-layer metric that lists the cell returns a number (the device ones
    from a trace whose device operations stand in the fused steps)."""
    real = profiling.count_sync
    monkeypatch.setattr(profiling, "count_sync",
                        lambda site, on_card, n=1: real(site, True, n))

    def one_op_a_step(prof):
        steps = [x for x in profiling.records() if x.name == "minibatch"]
        return (np.asarray([x.t0 + 1 for x in steps], np.int64),
                np.asarray([x.t1 - 1 for x in steps], np.int64),
                ["op"] * len(steps))
    monkeypatch.setattr(tracing, "device_events", one_op_a_step)
    profiling.clear()
    r = harness.Run(CELL, 2 ** 31 + 18181, 0.0, True, time.perf_counter(),
                    device="cpu")
    # the warm-up's length: three train events
    r.cfg["total_timesteps"] = 2 * r.agent.iteration_steps(r.cfg)
    assert r.cfg["total_timesteps"] == 1040
    out = r.driver.run(r)
    assert out["attempted"] == 1 and out["failed"] == 0
    for name, value in out["numbers"].items():
        assert value <= LIMITS[name], (name, value)
    metrics = out["metrics"]
    assert profiling.dropped() == 0
    recs = profiling.records()
    ids = {x.id: x for x in recs}

    def path(x):
        names = []
        while x is not None:
            names.append(x.name)
            x = ids.get(x.parent)
        return tuple(names[::-1])
    paths = {path(x) for x in recs}
    for p in (("iteration", "rollout", "mirror.forward"),
              ("iteration", "update", "minibatch", "update.stage"),
              ("iteration", "update", "minibatch", "target"),
              ("iteration", "update", "minibatch", "fit", "fit.level"),
              ("iteration", "update", "minibatch", "update.readback"),
              ("iteration", "mirror.sync")):
        assert p in paths, p
    its = [x for x in recs if x.name == "iteration"]
    steps = [x for x in recs if x.name == "minibatch"]
    events = [x for x in recs if x.name == "update"]
    # 1040 steps: 130 vector steps, train events after 1008, 1024 and 1040
    assert len(its) == 65 and len(events) == 3 and len(steps) == 6
    assert all(x.attrs == {"algo": "sac"} for x in events)
    assert all(x.attrs["learner"] == "sac" for x in steps)
    assert [x.counts.get("sync.sac_readback") for x in steps] == [1] * 6
    syncs = [x for x in recs if x.name == "mirror.sync"
             and ids[x.parent].name == "iteration"]
    assert [x.counts.get("sync.mirror_trees") for x in syncs] == [6] * 3
    assert profiling.counters().get("sync.sac_bias", 0) >= 4
    # two readbacks and the mirror's six a train event, over every
    # iteration of the unit
    assert metrics["counted_syncs_per_update"]["value"] == 8 * 3 / 65
    # one stand-in device operation a fused step: two an event, six trees
    assert metrics["launches_per_tree"]["value"] == 2 / 6
    assert metrics["graph_minibatch_pct"]["value"] == 0.0
    bench = json.loads((harness.ROOT / "BENCHMARK.json").read_text())
    names = [m["name"] for m in bench["per_layer"]
             if CELL in m.get("workloads", [CELL])]
    assert len(names) == 13
    for name in names:
        v = metrics[name]["value"]
        assert math.isfinite(v), name
    for name in ("rollout_ms", "update_ms", "mirror_forward_ms",
                 "minibatch_host_ms", "update_wait_ms",
                 "update_roofline_pct", "train_mfu_pct"):
        assert metrics[name]["value"] > 0, name
