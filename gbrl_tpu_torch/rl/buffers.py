"""Rollout storage with GAE(lambda) advantage estimation (a copy of
``gbrl_tpu/rl/buffers.py``, numpy only, with one addition: the rollout's
categorical codes beside its numeric block).

The reference delegates RL plumbing to the companion repo GBRL_SB3
(README.md:19) built on stable-baselines3; this is a self-contained
equivalent so the framework ships runnable PPO/A2C/AWR out of the box.
"""
from __future__ import annotations

import numpy as np


class RolloutBuffer:
    """``obs`` holds the numeric block of each observation; with
    ``cat_dim`` > 0, ``codes`` [n_steps, n_envs, cat_dim] int32 holds the
    categorical block as the learner's vocabulary codes (the numeric block
    may then have width 0)."""

    def __init__(self, n_steps: int, n_envs: int, obs_dim: int,
                 gamma: float = 0.99, gae_lambda: float = 0.95,
                 cat_dim: int = 0):
        self.n_steps = n_steps
        self.n_envs = n_envs
        self.gamma = gamma
        self.gae_lambda = gae_lambda
        self.obs = np.zeros((n_steps, n_envs, obs_dim), dtype=np.float32)
        self.codes = (np.zeros((n_steps, n_envs, cat_dim), dtype=np.int32)
                      if cat_dim else None)
        self.actions = np.zeros((n_steps, n_envs), dtype=np.int64)
        self.cont_actions = None
        self.rewards = np.zeros((n_steps, n_envs), dtype=np.float32)
        self.dones = np.zeros((n_steps, n_envs), dtype=np.float32)
        self.values = np.zeros((n_steps, n_envs), dtype=np.float32)
        self.log_probs = np.zeros((n_steps, n_envs), dtype=np.float32)
        self.pos = 0

    def add(self, obs, action, reward, done, value, log_prob, codes=None):
        t = self.pos
        self.obs[t] = obs
        if codes is not None:
            self.codes[t] = codes
        if action.dtype.kind == "f":
            if self.cont_actions is None:
                self.cont_actions = np.zeros(
                    (self.n_steps, self.n_envs) + action.shape[1:],
                    dtype=np.float32)
            self.cont_actions[t] = action
        else:
            self.actions[t] = action
        self.rewards[t] = reward
        self.dones[t] = done
        self.values[t] = value
        self.log_probs[t] = log_prob
        self.pos += 1

    def compute_returns(self, last_values: np.ndarray,
                        last_dones: np.ndarray):
        """GAE(lambda): delta_t = r_t + gamma*V(s_{t+1})*(1-d_t) - V(s_t)."""
        adv = np.zeros_like(self.rewards)
        gae = np.zeros(self.n_envs, dtype=np.float32)
        next_value = last_values
        next_nonterminal = 1.0 - last_dones
        for t in reversed(range(self.n_steps)):
            delta = (self.rewards[t] + self.gamma * next_value
                     * next_nonterminal - self.values[t])
            gae = delta + self.gamma * self.gae_lambda * next_nonterminal * gae
            adv[t] = gae
            next_value = self.values[t]
            next_nonterminal = 1.0 - self.dones[t]
        self.advantages = adv
        self.returns = adv + self.values
        self.pos = 0

    def flat(self, continuous: bool = False):
        """Flattened rollout + a ``valid`` mask: rows where the env
        auto-reset this step (gymnasium >=1.0 NextStep semantics: the
        stored done flag marks the episode boundary BEFORE the row, the
        action was ignored and the reward is 0) carry valid = 0 and must
        not contribute to updates."""
        n = self.n_steps * self.n_envs
        acts = (self.cont_actions.reshape(n, -1) if continuous
                else self.actions.reshape(n))
        return (self.obs.reshape(n, -1), acts,
                self.log_probs.reshape(n), self.advantages.reshape(n),
                self.returns.reshape(n), self.values.reshape(n),
                1.0 - self.dones.reshape(n))

    def flat_codes(self):
        """The categorical block flattened as ``flat`` flattens the rows:
        [n, cat_dim] int32, or None without one."""
        if self.codes is None:
            return None
        return self.codes.reshape(self.n_steps * self.n_envs, -1)


class ReplayBuffer:
    """Uniform off-policy ring buffer (for SAC).

    Each row carries its own bootstrap discount ``disc``: gamma for 1-step
    transitions, gamma^k for n-step ones (k < n at episode boundaries), so
    the TD target is ``R + disc * (1 - done) * Q(s_next, a')`` uniformly."""

    def __init__(self, capacity: int, obs_dim: int, act_dim: int):
        self.capacity = capacity
        self.obs = np.zeros((capacity, obs_dim), dtype=np.float32)
        self.actions = np.zeros((capacity, act_dim), dtype=np.float32)
        self.rewards = np.zeros(capacity, dtype=np.float32)
        self.next_obs = np.zeros((capacity, obs_dim), dtype=np.float32)
        self.dones = np.zeros(capacity, dtype=np.float32)
        self.discs = np.zeros(capacity, dtype=np.float32)
        self.pos = 0
        self.full = False

    def __len__(self) -> int:
        return self.capacity if self.full else self.pos

    def add(self, obs, action, reward, next_obs, done, disc):
        """Add a batch of [n_envs, ...] transitions."""
        n = len(obs)
        idx = (self.pos + np.arange(n)) % self.capacity
        self.obs[idx] = obs.reshape(n, -1)
        self.actions[idx] = action.reshape(n, -1)
        self.rewards[idx] = reward
        self.next_obs[idx] = next_obs.reshape(n, -1)
        self.dones[idx] = done
        self.discs[idx] = disc
        self.pos += n
        if self.pos >= self.capacity:
            self.full = True
            self.pos %= self.capacity

    def sample(self, batch_size: int, rng):
        idx = rng.integers(0, len(self), batch_size)
        return (self.obs[idx], self.actions[idx], self.rewards[idx],
                self.next_obs[idx], self.dones[idx], self.discs[idx])


class NStepAccumulator:
    """Per-env conversion of 1-step transition streams into n-step ones.

    Emits ``(s_t, a_t, sum_{i<k} gamma^i r_{t+i}, s_{t+k}, done, gamma^k)``
    with k == n in steady state and k < n at episode boundaries:
    terminations flush every pending transition with done=1 (no bootstrap);
    truncations flush with done=0 so the target bootstraps through the
    episode's final observation (gymnasium >=1.0 NextStep semantics hand
    exactly that observation to the caller).

    n_step=1 reduces to the ordinary 1-step replay feed (disc = gamma)."""

    def __init__(self, n_envs: int, n_step: int, gamma: float):
        self.n_step = int(n_step)
        self.gamma = float(gamma)
        self._pend = [[] for _ in range(n_envs)]   # [obs, act, R, k] each

    def add(self, env_idx: int, obs, action, reward: float, next_obs,
            terminated: bool, truncated: bool):
        """Feed one valid transition for env ``env_idx``; returns the list
        of matured n-step transitions (obs, act, R, next_obs, done, disc)."""
        pend = self._pend[env_idx]
        pend.append([obs, action, 0.0, 0])
        for p in pend:
            p[2] += (self.gamma ** p[3]) * float(reward)
            p[3] += 1
        out = []
        if terminated or truncated:
            done = 1.0 if terminated else 0.0
            for p in pend:
                out.append((p[0], p[1], p[2], next_obs, done,
                            self.gamma ** p[3]))
            pend.clear()
        else:
            while pend and pend[0][3] >= self.n_step:
                p = pend.pop(0)
                out.append((p[0], p[1], p[2], next_obs, 0.0,
                            self.gamma ** p[3]))
        return out
