"""The port's SAC ``learn`` loop on the CPU, where it departs from the JAX
package: a second ``learn`` starts with no n-step window of the first
(``gbrl_tpu``'s accumulator outlives ``learn``; ROADMAP Queue 3 item 2),
and the loop keeps a curve per train event."""
import os
import sys

import numpy as np

from gbrl_tpu_torch.rl.sac import SAC

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from bench_port import envs  # noqa: E402

E, N_STEP = 2, 3
TREE = dict(max_depth=2, n_bins=8, min_data_in_leaf=0, par_th=2,
            grow_policy="oblivious")


def agent(**kw) -> SAC:
    return SAC(envs.make("pendulum", E), tree_struct=dict(TREE),
               n_step=N_STEP, device="cpu", **kw)


def test_second_learn_joins_no_window_of_the_first():
    """Two runs of 6 vector steps on fresh episodes: each run's replay
    rows hold its own observations only, and each run adds the rows its
    own steps mature (6 - n + 1 a env); the first run's open windows are
    dropped, not finished with the second run's rewards."""
    a = agent(learning_starts=10 ** 6)
    a.learn(6 * E, seed=1)
    first = len(a.buffer)
    seen = a.buffer.obs[:first].copy()
    a.learn(6 * E, seed=2)
    assert first == len(a.buffer) - first == E * (6 - N_STEP + 1)
    second = a.buffer.obs[first:len(a.buffer)]
    shared = (second[:, None, :] == seen[None, :, :]).all(-1).any()
    assert not shared
    # the second run's first rows are the windows opened at its reset
    reset = envs.make("pendulum", E).reset(seed=2)[0]
    np.testing.assert_array_equal(second[:E], reset)


def test_curve_per_train_event():
    a = agent(learning_starts=64, batch_size=32, train_freq=2,
              gradient_steps=2)
    a.learn(128, seed=0)
    assert [c["steps"] for c in a.curve] == list(range(4, 129, 4))
    # train events from 64 env steps on (the replay holds a batch by then)
    trees = [c["trees"] for c in a.curve]
    assert trees[:15] == [0] * 15
    assert trees[15:] == list(range(2, 2 * 17 + 1, 2))
    assert a.actor.get_num_trees() == trees[-1]
    assert np.isfinite(a._last_rollout[1]).all()
    assert a._last_rollout[0].shape == (2, E, 3)
