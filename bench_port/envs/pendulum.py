"""Pendulum-v1 for ``n`` envs in numpy: a frozen copy of ``chip_smoke.py``'s
``VecPendulum``, so that the benchmark's inputs stay fixed whatever later changes
the smoke script.  The chip's machine has no gymnasium."""
from __future__ import annotations

import numpy as np


class VecPendulum:
    """Pendulum-v1 for ``n`` envs in numpy, with the interface AWR and SAC
    read from a gymnasium vector env (``num_envs``,
    ``single_observation_space.shape``, ``single_action_space.{low, high,
    shape}``, ``reset``, ``step``).  The equations and constants of
    gymnasium's ``envs/classic_control/pendulum.py`` on a float64 state
    (theta, theta_dot): g = 10, m = l = 1, dt = 0.05, speed clipped to 8,
    torque to 2, reward -(angle_normalize(theta)^2 + 0.1 theta_dot^2 +
    0.001 u^2) from the state before the step; observation (cos theta, sin
    theta, theta_dot); no termination, truncation after 200 steps (the
    TimeLimit of Pendulum-v1); the next-step autoreset of ``VecCartPole``.
    Resets draw theta ~ U(-pi, pi), theta_dot ~ U(-1, 1) with a numpy
    generator seeded by ``reset(seed)``."""
    G, M, L, DT, MAX_SPEED, MAX_TORQUE, MAX_STEPS = (10.0, 1.0, 1.0, 0.05,
                                                     8.0, 2.0, 200)

    def __init__(self, n: int):
        from types import SimpleNamespace
        self.num_envs = n
        self.single_observation_space = SimpleNamespace(shape=(3,))
        self.single_action_space = SimpleNamespace(
            low=np.full(1, -self.MAX_TORQUE, np.float32),
            high=np.full(1, self.MAX_TORQUE, np.float32), shape=(1,))
        self.rng = np.random.default_rng()
        self.state = np.zeros((n, 2))
        self.steps = np.zeros(n, np.int64)
        self.autoreset = np.zeros(n, bool)

    def _draw(self, k: int) -> np.ndarray:
        return self.rng.uniform(-np.array([np.pi, 1.0]), [np.pi, 1.0],
                                (k, 2))

    def _obs(self) -> np.ndarray:
        th, thdot = self.state[:, 0], self.state[:, 1]
        return np.stack([np.cos(th), np.sin(th), thdot],
                        axis=1).astype(np.float32)

    def reset(self, seed=None):
        self.rng = np.random.default_rng(seed)
        self.state = self._draw(self.num_envs)
        self.steps[:] = 0
        self.autoreset[:] = False
        return self._obs(), {}

    def step(self, actions):
        th, thdot = self.state[:, 0], self.state[:, 1]
        u = np.clip(np.asarray(actions, np.float32).reshape(self.num_envs),
                    -self.MAX_TORQUE, self.MAX_TORQUE)
        norm = (th + np.pi) % (2 * np.pi) - np.pi
        rewards = -(norm ** 2 + 0.1 * thdot ** 2 + 0.001 * u ** 2)
        newthdot = thdot + (3 * self.G / (2 * self.L) * np.sin(th)
                            + 3.0 / (self.M * self.L ** 2) * u) * self.DT
        newthdot = np.clip(newthdot, -self.MAX_SPEED, self.MAX_SPEED)
        self.state = np.stack([th + newthdot * self.DT, newthdot], axis=1)
        self.steps += 1
        terms = np.zeros(self.num_envs, bool)
        truncs = self.steps >= self.MAX_STEPS
        reset = self.autoreset
        if reset.any():
            self.state[reset] = self._draw(int(reset.sum()))
            self.steps[reset] = 0
            rewards[reset] = 0.0
            truncs[reset] = False
        self.autoreset = terms | truncs
        return self._obs(), rewards, terms, truncs, {}



def make(n_envs: int) -> VecPendulum:
    return VecPendulum(n_envs)


def random_actions(rng, n: int) -> np.ndarray:
    """[n, 1] torques drawn uniformly from the action space."""
    return rng.uniform(-VecPendulum.MAX_TORQUE, VecPendulum.MAX_TORQUE,
                       (n, 1)).astype(np.float32)
