"""A2C with shared policy/value GBT, Adam leaf optimizer and control
variates (counterpart of ``gbrl_tpu/rl/a2c.py``).

The model lives on ``device`` ("cuda" by default); rollouts are served on
the host by the ensemble mirror (utils/host_mirror.py) and each update runs
on the device (rl/jit_a2c.py).  The environment is any vector env with
gymnasium's interface; this module does not import gymnasium.
"""
from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch as th
from torch.distributions import Categorical

from ..models.actor_critic import ActorCritic
from ..utils import profiling
from .buffers import RolloutBuffer


class A2C:
    def __init__(self, env, tree_struct: Dict = None, params: Dict = None,
                 policy_lr: float = 0.05, value_lr: float = 0.01,
                 policy_algo: str = "SGD", n_steps: int = 64,
                 gamma: float = 0.99, gae_lambda: float = 0.95,
                 ent_coef: float = 0.01, vf_coef: float = 0.5,
                 control_variates: bool = False,
                 normalize_advantage: bool = True,
                 log_interval: int = 0, device: str = "cuda",
                 jit_update: bool = True):
        self.env = env
        self.n_envs = env.num_envs
        obs_dim = int(np.prod(env.single_observation_space.shape))
        n_actions = int(env.single_action_space.n)
        self.obs_dim, self.n_actions = obs_dim, n_actions
        out_dim = n_actions + 1
        tree_struct = dict(tree_struct or dict(
            max_depth=4, n_bins=256, min_data_in_leaf=0, par_th=2,
            grow_policy="oblivious"))
        params = dict(params or dict(split_score_func="cosine",
                                     generator_type="Quantile"))
        params["control_variates"] = control_variates
        self.model = ActorCritic(
            tree_struct=tree_struct, input_dim=obs_dim, output_dim=out_dim,
            policy_optimizer={"policy_algo": policy_algo,
                              "policy_lr": policy_lr,
                              "start_idx": 0, "stop_idx": n_actions},
            value_optimizer={"value_algo": "SGD", "value_lr": value_lr,
                             "start_idx": n_actions, "stop_idx": out_dim},
            shared_tree_struct=True, params=params, device=device)
        self.n_steps = n_steps
        self.gamma = gamma
        self.gae_lambda = gae_lambda
        self.ent_coef = ent_coef
        self.vf_coef = vf_coef
        self.normalize_advantage = normalize_advantage
        self.jit_update = jit_update
        self.log_interval = log_interval
        self.episode_rewards = []
        self._ep_ret = np.zeros(self.n_envs, dtype=np.float64)
        self._mirror = None

    def _get_mirror(self):
        """Host-resident ensemble mirror serving rollout forwards
        (utils/host_mirror.py; supports both SGD and Adam leaf
        optimizers — the Adam recurrence runs vectorized on host)."""
        if self._mirror is None:
            lr = self.model.learner
            if getattr(lr, "vocab", None) is None \
                    and getattr(lr, "student_model", None) is None \
                    and hasattr(lr, "ens"):
                from ..utils.host_mirror import HostMirror
                self._mirror = HostMirror(lr)
            else:
                self._mirror = False
        return self._mirror or None

    def _use_jit_update(self) -> bool:
        """Fused device update (rl/jit_a2c.py): available for plain
        numeric-feature learners (the facade path stays for categorical /
        distilled models and as the parity oracle)."""
        lr = self.model.learner
        return (self.jit_update
                and getattr(lr, "vocab", None) is None
                and getattr(lr, "student_model", None) is None
                and hasattr(lr, "ens"))

    def _sample_np(self, obs, rng, mirror, span=profiling.span):
        """Numpy categorical sampling from mirror predictions; the mirror's
        forward is a ``mirror.forward`` span (``span``: the rollout's, read
        once).  Returns (actions i64 [N], log_probs f32 [N], values [N])."""
        with span("mirror.forward", rows=len(obs)):
            preds = mirror.predict(np.asarray(obs, dtype=np.float32))
        na = self.n_actions
        logits = preds[:, :na] - preds[:, :na].max(axis=1, keepdims=True)
        logp = logits - np.log(np.exp(logits).sum(axis=1, keepdims=True))
        p = np.exp(logp)
        u = rng.random(p.shape[0])
        actions = (u[:, None] >= np.cumsum(p, axis=1)).sum(axis=1)
        np.clip(actions, 0, na - 1, out=actions)
        lp = np.take_along_axis(logp, actions[:, None], axis=1)[:, 0]
        return actions, lp.astype(np.float32), preds[:, na]

    def collect_rollout(self, buffer: RolloutBuffer, obs, dones, rng):
        """``n_steps`` env steps into ``buffer``, then the bootstrap values
        and the returns; served by the host mirror where there is one.
        Returns the next (obs, dones)."""
        span = profiling.spanner()
        mirror = self._get_mirror()
        for _ in range(self.n_steps):
            if mirror is not None:
                a_np, log_probs, values = self._sample_np(obs, rng, mirror,
                                                          span)
            else:
                theta, value = self.model(obs, requires_grad=False)
                theta, value = theta.cpu(), value.cpu()
                dist = Categorical(logits=theta)
                actions = dist.sample()
                log_probs = dist.log_prob(actions).numpy()
                a_np = actions.numpy()
                values = value.detach().numpy().reshape(-1)
            next_obs, rewards, terms, truncs, _ = self.env.step(a_np)
            done_now = np.logical_or(terms, truncs).astype(np.float32)
            buffer.add(obs, a_np, rewards, dones, values, log_probs)
            self._ep_ret += rewards
            for i in range(self.n_envs):
                if done_now[i]:
                    self.episode_rewards.append(self._ep_ret[i])
                    self._ep_ret[i] = 0.0
            obs, dones = next_obs, done_now
        if mirror is not None:
            with span("mirror.forward", rows=len(obs)):
                last_values = mirror.predict(
                    np.asarray(obs, dtype=np.float32))[:, self.n_actions]
        else:
            _, last_value = self.model(obs, requires_grad=False)
            last_values = last_value.detach().cpu().numpy().reshape(-1)
        buffer.compute_returns(last_values, dones)
        return obs, dones

    def update(self, buffer: RolloutBuffer):
        """One tree from the rollout in ``buffer``: the fused device update
        (rl/jit_a2c.py), or the facade path (the model's forward, torch's
        autograd and ``ActorCritic.step``) where it does not apply."""
        b_obs, b_act, _, adv, ret, _, valid = buffer.flat()
        mirror = self._get_mirror()
        if self._use_jit_update():
            from .jit_a2c import A2CHyper, run_a2c_update
            hp = A2CHyper(n_actions=self.n_actions,
                          ent_coef=self.ent_coef, vf_coef=self.vf_coef,
                          normalize_advantage=self.normalize_advantage)
            run_a2c_update(self.model.learner, b_obs, b_act, adv, ret,
                           valid, hp, mirror=mirror)
            return
        theta, values = self.model(b_obs, requires_grad=True)
        dev = theta.device
        dist = Categorical(logits=theta)
        w = th.as_tensor(valid, device=dev)
        nw = w.sum().clamp(min=1.0)
        adv_t = th.as_tensor(adv, device=dev)
        if self.normalize_advantage:
            m = (adv_t * w).sum() / nw
            var = (w * (adv_t - m) ** 2).sum() / (nw - 1.0).clamp(min=1.0)
            adv_t = (adv_t - m) / (var.sqrt() + 1e-8)
        log_prob = dist.log_prob(th.as_tensor(b_act, device=dev))
        policy_loss = -(w * adv_t * log_prob).sum() / nw
        entropy_loss = -(w * dist.entropy()).sum() / nw
        (policy_loss + self.ent_coef * entropy_loss).backward()
        value_loss = self.vf_coef * 0.5 * (
            w * (th.as_tensor(ret, device=dev) - values) ** 2).sum() / nw
        value_loss.backward()
        self.model.step()
        if mirror is not None:
            mirror.sync()

    def learn(self, total_timesteps: int, seed: int = 0):
        rng = np.random.default_rng(seed)
        obs, _ = self.env.reset(seed=seed)
        dones = np.zeros(self.n_envs, dtype=np.float32)
        buffer = RolloutBuffer(self.n_steps, self.n_envs, self.obs_dim,
                               self.gamma, self.gae_lambda)
        self._buffer = buffer     # the last rollout (diagnostics, tests)
        self.curve = []
        steps, it = 0, 0
        mirror = self._get_mirror()
        if self._use_jit_update():
            # preallocate capacity for the whole run: the per-iteration
            # ensure_capacity becomes a host-only no-op
            from ..ensemble import ensure_capacity
            lr = self.model.learner
            profiling.count_sync("a2c_n_trees", lr.ens.n_trees.is_cuda)
            n0 = int(lr.ens.n_trees)
            iters_planned = -(-total_timesteps
                              // (self.n_steps * self.n_envs))
            lr.ens = ensure_capacity(lr.ens, n0 + iters_planned)
            lr._rl_host_n_trees = n0
        if mirror is not None:
            # a warm-started learner (trees/bias set before this learn()
            # call) must be mirrored before the first rollout — the jit
            # path only syncs after each update
            mirror.sync()
        while steps < total_timesteps:
            # spans (utils/profiling.py): an ``iteration`` holds the
            # ``rollout`` and the ``update``
            with profiling.span("iteration", it=it):
                with profiling.span("rollout"):
                    obs, dones = self.collect_rollout(buffer, obs, dones,
                                                      rng)
                self.update(buffer)
            steps += self.n_steps * self.n_envs
            it += 1
            ntr = getattr(self.model.learner, "_rl_host_n_trees", None)
            if ntr is None:
                ntr = self.model.get_num_trees()
            self.curve.append(dict(
                steps=steps, mean_reward_100=self.mean_reward(),
                trees=ntr))
            if self.log_interval and it % self.log_interval == 0:
                mean100 = (np.mean(self.episode_rewards[-100:])
                           if self.episode_rewards else float("nan"))
                print(f"iter {it} steps {steps} trees "
                      f"{ntr} ep_rew_mean {mean100:.1f}")
        return self

    def mean_reward(self, last: int = 100) -> float:
        if not self.episode_rewards:
            return float("nan")
        return float(np.mean(self.episode_rewards[-last:]))
