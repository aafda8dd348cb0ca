"""The check of ``ppo_minigrid.train`` must fail what it exists to catch,
at a small size on the CPU: a sound run is correct; the control (the plain
reference in bfloat16 in the program's place) and the planted faults (a
state left unchanged, half minibatches, codes shifted by one between the
rollout and the fit, the update after the checked one fit from the bias
as if its load walked no tree) are not.  The unit seed is one whose third
rollout holds a reward, so that the checked update carries gradients; a
fourth iteration follows it, so that the check reads that one too."""
import time

import numpy as np
import pytest
import torch

from bench_port import harness
from bench_port.traffic import learn

SEED = 12345


def small_run():
    r = harness.Run("ppo_minigrid.train", SEED, 0.0, False,
                    time.perf_counter(), device="cpu")
    r.cfg["total_timesteps"] = 4 * r.agent.iteration_steps(r.cfg)
    return r


def test_checked_update_holds_a_reward():
    r = small_run()
    st = r.reference._replay(r.cfg, learn.unit_seeds(SEED, 2)[1])
    data, plan = r.reference.inputs(r.cfg, None, st)
    assert data["update"] == 2 and (data["ret"] != 0).any()
    assert len(plan) == 32 and data["codes"].shape == (4096, 50)
    assert r.reference.has_next(st)


def test_sound_run_is_correct():
    r = small_run()
    out = r.driver.run(r)
    assert harness.judge(r, out["numbers"], out["failed"])[0], out["numbers"]


@pytest.mark.parametrize("side", ["control", "half_batch", "unchanged",
                                  "code_shift", "stale_load"])
def test_control_and_faults_are_not_correct(side):
    r = small_run()
    seed = learn.unit_seeds(SEED, 2)[1]
    dtype = torch.bfloat16 if side == "control" else torch.float64
    stand = r.reference.stand_in(r.cfg, seed, 3, dtype,
                                 fault="" if side == "control" else side)
    ok, _ = harness.judge(r, r.reference.train_check(stand, r.cfg, seed, 3),
                          0)
    assert not ok


def test_vocab_one_batch_at_a_time():
    rng = np.random.default_rng(3)
    seen = [rng.choice(["b", "a", "d", "c", "e"], size=(4, 3))
            for _ in range(6)]
    from bench_port.reference import ppo_categorical as R
    vocab = R.Vocab(seen[:2])
    got = [vocab.encode(o) for o in seen[2:]]
    want = R.encode_all(seen)[2:]
    assert all((g == w).all() for g, w in zip(got, want))
