"""The check that decides ``correct`` must fail what it exists to catch.

The control: the plain reference put in the program's place in the next
precision below the configuration's (bfloat16 for float32) comes out not
correct.  The faults: a run driven past the harness's look for a chip, on
the CPU, with the timed path broken underneath, comes out not correct:
a step that leaves its state unchanged, a step that fits on half of its
batch (the mean taken over the rest), a served answer altered where it is
produced.  (No cell spans chips, so no exchange can be left out.)"""
import time

import numpy as np
import pytest
import torch

from bench_port import envs, harness

TRAIN = ["ppo_cartpole.train", "awr_pendulum.train"]
SERVE = ["ppo_cartpole.serve", "awr_pendulum.serve"]


def small_run(cell: str):
    r = harness.Run(cell, 4321, 0.0, False, time.perf_counter(), device="cpu")
    if r.mix["driver"] == "learn":
        r.cfg["total_timesteps"] = 3 * r.agent.iteration_steps(r.cfg)
    else:
        r.cfg["served_trees"] = 60
        r.mix["check_requests"] = 32
        r.seconds = 0.3
    return r


def correct(r) -> bool:
    out = r.driver.run(r)
    return harness.judge(r, out["numbers"], out["failed"])[0]


@pytest.mark.parametrize("cell", TRAIN + SERVE)
def test_sound_run_is_correct(cell):
    assert correct(small_run(cell))


@pytest.mark.parametrize("cell", TRAIN)
def test_control_is_not_correct(cell):
    r = small_run(cell)
    k = r.mix["check_steps"]
    seed = 77
    stand = r.reference.stand_in(r.cfg, seed, k, torch.bfloat16)
    ok, _ = harness.judge(r, r.reference.train_check(stand, r.cfg, seed, k),
                          0)
    assert not ok


@pytest.mark.parametrize("cell", SERVE)
def test_serve_control_is_not_correct(cell):
    from bench_port.traffic import serve
    r = small_run(cell)
    r.cfg["served_trees"] = 200
    rng = np.random.default_rng(0)
    pool = envs.visited_states(r.cfg["env"], r.cfg["n_envs"], 64, rng)
    arrays = serve.make_ensemble(r.cfg, 5, pool, "cpu")
    ens = serve.served_ensemble(r, arrays)
    X = envs.visited_states(r.cfg["env"], 300, 1, rng)
    ctrl = [r.reference.serve_outputs(r.cfg, X, ens, torch.bfloat16)]
    gap = serve.output_gap(r, arrays, [X], ctrl)
    assert gap > r.limits["output_gap"]


def _unchanged(monkeypatch):
    from gbrl_tpu_torch.rl import jit_sac, jit_update
    monkeypatch.setattr(jit_update, "write_tree", lambda ens, tree, idx: ens)
    monkeypatch.setattr(jit_sac, "write_tree", lambda ens, tree, idx: ens)


def _half_batch(monkeypatch):
    from gbrl_tpu_torch.rl import jit_sac, jit_update
    for mod in (jit_update, jit_sac):
        orig = mod.build_tree

        def half(cfg, Xb, cand, grads, build, w, fw, *rest, _orig=orig):
            keep = torch.arange(len(w), device=w.device) < len(w) // 2
            return _orig(cfg, Xb, cand, grads, build, w * keep, fw, *rest)
        monkeypatch.setattr(mod, "build_tree", half)


@pytest.mark.parametrize("fault", [_unchanged, _half_batch],
                         ids=["unchanged", "half_batch"])
@pytest.mark.parametrize("cell", TRAIN)
def test_training_fault_is_caught(cell, fault, monkeypatch):
    fault(monkeypatch)
    assert not correct(small_run(cell))


@pytest.mark.parametrize("cell", SERVE)
def test_altered_answer_is_caught(cell, monkeypatch):
    from gbrl_tpu_torch.ops import boosting
    orig = boosting.weighted_leaf_sum

    def altered(*a, **k):
        out = orig(*a, **k).clone()
        out[0, 0] += 1.0
        return out
    monkeypatch.setattr(boosting, "weighted_leaf_sum", altered)
    assert not correct(small_run(cell))
