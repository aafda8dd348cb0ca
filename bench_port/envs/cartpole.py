"""CartPole-v1 for ``n`` envs in numpy: a frozen copy of ``chip_smoke.py``'s
``VecCartPole``, so that the benchmark's inputs stay fixed whatever later changes
the smoke script.  The chip's machine has no gymnasium."""
from __future__ import annotations

import math
import numpy as np


class VecCartPole:
    """CartPole-v1 for ``n`` envs in numpy, with the interface PPO and A2C
    read from a gymnasium vector env (``num_envs``,
    ``single_observation_space.shape``, ``single_action_space.n``, ``reset``,
    ``step``): the card's machine has no gymnasium.  The equations, constants
    and Euler step of gymnasium's ``envs/classic_control/cartpole.py`` on a
    float64 state; termination at |x| > 2.4 or |theta| > 12 degrees; reward 1
    on every stepped row; truncation after 500 steps (the TimeLimit of
    CartPole-v1); and the next-step autoreset of gymnasium's vector envs: a
    row that ended is reset on the following step, which returns the reset
    observation, reward 0 and neither flag (``RolloutBuffer.flat`` masks such
    rows).  Resets draw from U(-0.05, 0.05) with a numpy generator seeded by
    ``reset(seed)``."""
    GRAVITY, MASSCART, MASSPOLE, LENGTH = 9.8, 1.0, 0.1, 0.5
    FORCE_MAG, TAU, X_LIMIT, MAX_STEPS = 10.0, 0.02, 2.4, 500
    THETA_LIMIT = 12 * 2 * math.pi / 360

    def __init__(self, n: int):
        from types import SimpleNamespace
        self.num_envs = n
        self.single_observation_space = SimpleNamespace(shape=(4,))
        self.single_action_space = SimpleNamespace(n=2)
        self.rng = np.random.default_rng()
        self.state = np.zeros((n, 4))
        self.steps = np.zeros(n, np.int64)
        self.autoreset = np.zeros(n, bool)

    def reset(self, seed=None):
        self.rng = np.random.default_rng(seed)
        self.state = self.rng.uniform(-0.05, 0.05, (self.num_envs, 4))
        self.steps[:] = 0
        self.autoreset[:] = False
        return self.state.astype(np.float32), {}

    def step(self, actions):
        total_mass = self.MASSPOLE + self.MASSCART
        polemass_length = self.MASSPOLE * self.LENGTH
        x, x_dot, theta, theta_dot = (self.state[:, i].copy()
                                      for i in range(4))
        force = np.where(np.asarray(actions) == 1, self.FORCE_MAG,
                         -self.FORCE_MAG)
        costheta, sintheta = np.cos(theta), np.sin(theta)
        temp = (force + polemass_length * np.square(theta_dot) * sintheta
                ) / total_mass
        thetaacc = (self.GRAVITY * sintheta - costheta * temp) / (
            self.LENGTH * (4.0 / 3.0 - self.MASSPOLE * np.square(costheta)
                           / total_mass))
        xacc = temp - polemass_length * thetaacc * costheta / total_mass
        x = x + self.TAU * x_dot
        x_dot = x_dot + self.TAU * xacc
        theta = theta + self.TAU * theta_dot
        theta_dot = theta_dot + self.TAU * thetaacc
        stepped = np.stack([x, x_dot, theta, theta_dot], axis=1)
        terms = ((x < -self.X_LIMIT) | (x > self.X_LIMIT)
                 | (theta < -self.THETA_LIMIT) | (theta > self.THETA_LIMIT))
        self.steps += 1
        truncs = self.steps >= self.MAX_STEPS
        rewards = np.ones(self.num_envs)
        reset = self.autoreset
        self.state = np.where(reset[:, None], 0.0, stepped)
        if reset.any():
            self.state[reset] = self.rng.uniform(-0.05, 0.05,
                                                 (int(reset.sum()), 4))
            self.steps[reset] = 0
            rewards[reset] = 0.0
            terms[reset] = False
            truncs[reset] = False
        self.autoreset = terms | truncs
        return (self.state.astype(np.float32), rewards, terms, truncs, {})



def make(n_envs: int) -> VecCartPole:
    return VecCartPole(n_envs)


def random_actions(rng, n: int) -> np.ndarray:
    """[n] actions drawn uniformly from the action space."""
    return rng.integers(0, 2, n)
