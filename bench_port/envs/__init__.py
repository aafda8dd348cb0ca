"""The benchmark's environments, found by the name a configuration gives
(``"env"``).  Each module defines ``make(n_envs)`` (a vector env with
gymnasium's interface) and ``random_actions(rng, n)`` (actions drawn
uniformly from its action space)."""
from __future__ import annotations

import importlib

import numpy as np


def module(name: str):
    return importlib.import_module(f"{__name__}.{name}")


def make(name: str, n_envs: int):
    return module(name).make(n_envs)


def visited_states(name: str, n_envs: int, steps: int, rng) -> np.ndarray:
    """[steps * n_envs, F] states the env visits under random actions, from
    a reset seeded by ``rng``."""
    mod = module(name)
    env = mod.make(n_envs)
    obs, _ = env.reset(seed=int(rng.integers(2 ** 31)))
    out = [obs]
    for _ in range(steps - 1):
        obs = env.step(mod.random_actions(rng, n_envs))[0]
        out.append(obs)
    return np.concatenate(out)
