"""The check of ``a2c_cartpole.train`` must fail what it exists to catch,
at a small size on the CPU: a sound 4-iteration unit is correct; the
control (the plain reference in bfloat16 in the program's place) and the
planted faults (a state left unchanged, half the rollout's rows, the
policy predicted by SGD where it takes Adam, the fit on gradients the
control variates did not correct, one forward of the last rollout
altered) are not."""
import time

import pytest
import torch

from bench_port import harness
from bench_port.traffic import learn

SEED = 2147483001


def small_run():
    r = harness.Run("a2c_cartpole.train", SEED, 0.0, False,
                    time.perf_counter(), device="cpu")
    r.cfg["total_timesteps"] = 4 * r.agent.iteration_steps(r.cfg)
    return r


def test_sound_run_is_correct():
    r = small_run()
    out = r.driver.run(r)
    assert harness.judge(r, out["numbers"], out["failed"])[0], out["numbers"]


@pytest.mark.parametrize("side", ["control", "half_batch", "unchanged",
                                  "sgd_policy", "no_cv", "altered"])
def test_control_and_faults_are_not_correct(side):
    r = small_run()
    seed = learn.unit_seeds(SEED, 2)[1]
    dtype = torch.bfloat16 if side == "control" else torch.float64
    stand = r.reference.stand_in(r.cfg, seed, 3, dtype,
                                 fault="" if side == "control" else side)
    ok, _ = harness.judge(r, r.reference.train_check(stand, r.cfg, seed, 3),
                          0)
    assert not ok


def test_reference_in_its_own_place_is_correct():
    """The reference's own readings pass its check: the gaps measure the
    program, not the replay."""
    r = small_run()
    seed = learn.unit_seeds(SEED, 2)[1]
    stand = r.reference.stand_in(r.cfg, seed, 3)
    nums = r.reference.train_check(stand, r.cfg, seed, 3)
    assert max(nums.values()) < 1e-9, nums


def test_adam_work_count():
    """The Adam delta's work against a count made by hand at a tiny shape."""
    from bench_port.work import a2c
    cfg = dict(obs_dim=3, n_actions=2, tree_struct=dict(
        max_depth=2, n_bins=4, grow_policy="oblivious"))
    ops, byt = a2c.adam(cfg, rows=5, n_trees=7)
    # per row and tree: 2 compares, then 12 operations per Adam column
    assert ops == 5 * 7 * (2 + 2 * 12)
    # rows and delta; per tree 3 nodes of 9 bytes and 4 leaves of 2 floats
    assert byt == 5 * (3 + 2) * 4 + 7 * (3 * 9 + 4 * 2 * 4)
