"""PPO with a shared policy/value GBT ensemble (counterpart of
``gbrl_tpu/rl/ppo.py``).

Matches the GBRL paper setup: one ActorCritic model whose policy columns and
value column carry separate SGD optimizers; every PPO minibatch update fits
exactly one tree from the clipped-surrogate + value-loss gradients (the
same integration shape as the reference's GBRL_SB3 companion repo).  The
model lives on ``device`` ("cuda" by default); rollouts are served on the
host by the ensemble mirror (utils/host_mirror.py) and each update phase
runs on the device (rl/jit_update.py).  The environment is any vector env
with gymnasium's interface (``num_envs``, ``single_observation_space.shape``,
``single_action_space.n``, ``reset`` and ``step``); this module does not
import gymnasium.

Observations may be categorical: a space whose ``dtype`` is a string or
object kind (``S``, ``U``, ``O``) gives the learner a vocabulary
(common/utils.py ``CategoryVocab``).  Each env step's observation is
encoded once on the host (``_features``: new values get new codes), the
buffer keeps the codes beside the numeric block, the mirror walks them and
the fused update fits on them through the general tree path.  A value first
seen in a rollout matches no split until a tree splits on it, as a string
never fitted matches none in NVlabs/gbrl.
"""
from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch as th
from torch.distributions import Categorical

from ..common.utils import preprocess_features
from ..models.actor_critic import ActorCritic
from ..utils import profiling
from .buffers import RolloutBuffer


class PPO:
    """PPO over gymnasium vector envs.

    ``env`` may also be a LIST of vector envs ("env groups"): rollouts then
    pipeline across groups — while one group's action predictions are being
    fetched from the device, the other groups' predicts are already in
    flight (learner.predict_async), hiding device round-trip latency behind
    host env stepping.  Semantics stay exactly on-policy; only the
    host/device schedule changes."""

    def __init__(self, env, tree_struct: Dict = None, params: Dict = None,
                 policy_lr: float = 0.17, value_lr: float = 0.01,
                 n_steps: int = 512, batch_size: int = 512,
                 n_epochs: int = 4, gamma: float = 0.99,
                 gae_lambda: float = 0.95, clip_range: float = 0.2,
                 ent_coef: float = 0.0, vf_coef: float = 0.5,
                 max_policy_grad_norm: Optional[float] = None,
                 max_value_grad_norm: Optional[float] = None,
                 normalize_advantage: bool = True,
                 log_interval: int = 0, device: str = "cuda",
                 total_iterations: Optional[int] = None,
                 jit_update: bool = True):
        self.env_groups = list(env) if isinstance(env, (list, tuple)) \
            else [env]
        env = self.env_groups[0]
        assert all(e.num_envs == env.num_envs for e in self.env_groups), \
            "all env groups must have the same number of envs"
        self.env = env
        self.n_envs = env.num_envs
        space = env.single_observation_space
        obs_dim = int(np.prod(space.shape))
        self.categorical = np.dtype(
            getattr(space, "dtype", np.float32)).kind in "SUO"
        if self.categorical and not jit_update:
            raise ValueError("categorical observations train through the "
                             "fused update (jit_update=True)")
        n_actions = int(env.single_action_space.n)
        self.obs_dim = obs_dim
        self.n_actions = n_actions
        out_dim = n_actions + 1
        tree_struct = dict(tree_struct or dict(
            max_depth=4, n_bins=256, min_data_in_leaf=0, par_th=2,
            grow_policy="greedy"))
        params = dict(params or dict(split_score_func="cosine",
                                     generator_type="Quantile"))
        popt = {"policy_algo": "SGD", "policy_lr": policy_lr,
                "start_idx": 0, "stop_idx": n_actions}
        vopt = {"value_algo": "SGD", "value_lr": value_lr,
                "start_idx": n_actions, "stop_idx": out_dim}
        if total_iterations is not None:
            # "lin_<lr>" schedules anneal over T trees (reference
            # scheduler.h:124-133; optimizer-dict "T" convention)
            popt["T"] = vopt["T"] = int(total_iterations)
        self.model = ActorCritic(
            tree_struct=tree_struct, input_dim=obs_dim, output_dim=out_dim,
            policy_optimizer=popt, value_optimizer=vopt,
            shared_tree_struct=True, params=params, device=device)
        if self.categorical and np.dtype(space.dtype).kind in "SU":
            # every column a category: the vocabulary exists from here on
            self.model.learner.set_feature_mapping(np.zeros(obs_dim, bool))
        self.n_steps = n_steps
        self.batch_size = batch_size
        self.n_epochs = n_epochs
        self.gamma = gamma
        self.gae_lambda = gae_lambda
        self.clip_range = clip_range
        self.ent_coef = ent_coef
        self.vf_coef = vf_coef
        self.max_policy_grad_norm = max_policy_grad_norm
        self.max_value_grad_norm = max_value_grad_norm
        self.normalize_advantage = normalize_advantage
        self.jit_update = jit_update
        self.log_interval = log_interval
        self.episode_rewards = []
        self._ep_ret = np.zeros((len(self.env_groups), self.n_envs),
                                dtype=np.float64)
        self._mirror = None

    # ----------------------------------------------------------- host mirror
    def _get_mirror(self):
        """Host-resident ensemble mirror serving rollout forwards
        (utils/host_mirror.py): per-env-step predicts on tiny batches would
        pay a device round trip each; the mirror syncs only the NEW trees
        after each update phase and walks them on the host like the
        reference's own CPU predictor (predictor.cpp:122-184)."""
        if self._mirror is None:
            from ..learners.actor_critic_learner import \
                SharedActorCriticLearner
            lr = self.model.learner
            if (isinstance(lr, SharedActorCriticLearner)
                    and all(s.algo == "SGD" for s in lr.specs)
                    and getattr(lr, "student_model", None) is None):
                from ..utils.host_mirror import HostMirror
                self._mirror = HostMirror(lr)
            else:
                self._mirror = False
        return self._mirror or None

    # -------------------------------------------------------------- rollout
    def _policy_value(self, obs: np.ndarray):
        mirror = self._get_mirror()
        if mirror is not None:
            preds = mirror.predict(np.asarray(obs, dtype=np.float32))
            theta = th.from_numpy(preds[:, :self.n_actions].copy())
            value = th.from_numpy(preds[:, self.n_actions].copy())
            return theta, value
        theta, value = self.model(obs, requires_grad=False, tensor=True)
        return theta.cpu(), value.cpu()

    def _features(self, obs, span=profiling.span):
        """An env step's observation as (numeric block f32 [N, Fn],
        categorical codes i32 [N, Fc] or None): numeric observations pass
        as they are; categorical ones are encoded once, growing the
        vocabulary, in a ``vocab.encode`` span."""
        if not self.categorical:
            return obs, None
        lr = self.model.learner
        with span("vocab.encode", rows=len(obs), features=lr.input_dim):
            num, cat = preprocess_features(obs)
            codes = lr.vocab.encode(cat, grow=True)
        if num is None:
            num = np.zeros((len(codes), 0), np.float32)
        return num, codes

    def _sample_np(self, obs: np.ndarray, rng, span=profiling.span,
                   codes: Optional[np.ndarray] = None):
        """Numpy categorical sampling from mirror predictions: torch's
        per-op overhead dominates tiny rollout batches.  ``obs`` is the
        numeric block and ``codes`` the categorical one (``_features``).
        Returns (actions i64 [N], log_probs f32 [N], values [N]).  The
        mirror's forward is a ``mirror.forward`` span (``span``: the
        rollout's, read once)."""
        mirror = self._get_mirror()
        with span("mirror.forward", rows=len(obs)):
            preds = mirror.predict(np.asarray(obs, dtype=np.float32), codes)
        logits = preds[:, :self.n_actions]
        logits = logits - logits.max(axis=1, keepdims=True)
        logp = logits - np.log(np.exp(logits).sum(axis=1, keepdims=True))
        p = np.exp(logp)
        u = rng.random(p.shape[0])
        cum = np.cumsum(p, axis=1)
        actions = (u[:, None] >= cum).sum(axis=1)
        np.clip(actions, 0, self.n_actions - 1, out=actions)
        lp = np.take_along_axis(logp, actions[:, None], axis=1)[:, 0]
        return actions, lp.astype(np.float32), preds[:, self.n_actions]

    def _track_episodes(self, g: int, rewards, done_now):
        self._ep_ret[g] += rewards
        for i in range(self.n_envs):
            if done_now[i]:
                self.episode_rewards.append(self._ep_ret[g, i])
                self._ep_ret[g, i] = 0.0

    def _mirror_rollout(self, g: int, buffer: RolloutBuffer, obs, dones,
                        rng, span):
        """One rollout of env group ``g`` served by the host mirror, its
        bootstrap values included."""
        env = self.env_groups[g]
        for _ in range(self.n_steps):
            x, codes = self._features(obs, span)
            actions_np, log_probs, values = self._sample_np(x, rng, span,
                                                            codes)
            next_obs, rewards, terms, truncs, _ = env.step(actions_np)
            done_now = np.logical_or(terms, truncs).astype(np.float32)
            buffer.add(x, actions_np, rewards, dones, values, log_probs,
                       codes)
            self._track_episodes(g, rewards, done_now)
            obs, dones = next_obs, done_now
        x, codes = self._features(obs, span)
        with span("mirror.forward", rows=len(x)):
            preds = self._get_mirror().predict(
                np.asarray(x, dtype=np.float32), codes)
        buffer.compute_returns(preds[:, self.n_actions], dones)
        return obs, dones

    def collect_rollout(self, buffer: RolloutBuffer, obs, dones, rng):
        span = profiling.spanner()
        if self._get_mirror() is not None:
            return self._mirror_rollout(0, buffer, obs, dones, rng, span)
        for _ in range(self.n_steps):
            theta, value = self._policy_value(obs)
            dist = Categorical(logits=theta)
            actions = dist.sample()
            log_probs = dist.log_prob(actions).numpy()
            actions_np = actions.numpy()
            values = value.detach().numpy().reshape(-1)
            next_obs, rewards, terms, truncs, _ = self.env.step(actions_np)
            done_now = np.logical_or(terms, truncs).astype(np.float32)
            buffer.add(obs, actions_np, rewards, dones, values, log_probs)
            self._track_episodes(0, rewards, done_now)
            obs, dones = next_obs, done_now
        _, last_value = self._policy_value(obs)
        buffer.compute_returns(last_value.detach().numpy().reshape(-1),
                               dones)
        return obs, dones

    def collect_rollout_pipelined(self, buffers, obs_list, dones_list, rng):
        """Multi-group rollout: read group g's queued predictions, step its
        envs, queue its next predict, while groups g+1.. compute on the
        device.  The dangling predictions after the last step are exactly
        the bootstrap values."""
        G = len(self.env_groups)
        learner = self.model.learner
        na = self.n_actions
        mirror = self._get_mirror()
        if mirror is not None:
            # host mirror makes forwards ~us: no pipelining needed
            span = profiling.spanner()
            for g in range(G):
                obs_list[g], dones_list[g] = self._mirror_rollout(
                    g, buffers[g], obs_list[g], dones_list[g], rng, span)
            return obs_list, dones_list
        futures = [learner.predict_async(obs_list[g]) for g in range(G)]
        for _ in range(self.n_steps):
            for g in range(G):
                preds = futures[g].cpu().numpy()
                theta = th.from_numpy(preds[:, :na].copy())
                value = preds[:, na].copy()
                dist = Categorical(logits=theta)
                actions = dist.sample()
                log_probs = dist.log_prob(actions).numpy()
                a_np = actions.numpy()
                next_obs, rewards, terms, truncs, _ = \
                    self.env_groups[g].step(a_np)
                done_now = np.logical_or(terms, truncs).astype(np.float32)
                buffers[g].add(obs_list[g], a_np, rewards, dones_list[g],
                               value.reshape(-1), log_probs)
                self._track_episodes(g, rewards, done_now)
                obs_list[g], dones_list[g] = next_obs, done_now
                futures[g] = learner.predict_async(next_obs)
        for g in range(G):
            preds = futures[g].cpu().numpy()
            buffers[g].compute_returns(preds[:, na].reshape(-1),
                                       dones_list[g])
        return obs_list, dones_list

    # --------------------------------------------------------------- update
    def _can_jit_update(self) -> bool:
        from ..learners.actor_critic_learner import SharedActorCriticLearner
        lr = self.model.learner
        return (self.jit_update
                and isinstance(lr, SharedActorCriticLearner)
                and all(s.algo == "SGD" for s in lr.specs))

    def update(self, buffer: RolloutBuffer, rng):
        """PPO epochs over minibatches; one tree per minibatch update.

        Default path: the whole update phase (every epoch x minibatch) runs
        as one loop on the device (rl/jit_update.ppo_update_loop), with no
        host synchronisation per minibatch; it takes the rollout's
        categorical codes too.  The facade path below is kept for Adam /
        separate-learner configs and as the semantics reference.

        Predictions for the whole rollout are fetched through the learner's
        incremental cache: after each tree only the NEW tree is evaluated on
        the rollout (leaf values are immutable), so an update phase costs
        O(new_trees * N) instead of O(ensemble * N) per minibatch."""
        buffers = buffer if isinstance(buffer, (list, tuple)) else [buffer]
        flats = [b.flat() for b in buffers]
        obs, actions, old_log_probs, advantages, returns, _, valid = (
            np.concatenate([f[i] for f in flats]) for i in range(7))
        codes = (np.concatenate([b.flat_codes() for b in buffers])
                 if self.categorical else None)
        if self._can_jit_update():
            from .jit_update import PPOHyper, run_ppo_update
            hp = PPOHyper(
                n_actions=self.n_actions, clip_range=self.clip_range,
                ent_coef=self.ent_coef, vf_coef=self.vf_coef,
                normalize_advantage=self.normalize_advantage,
                policy_clip=self.max_policy_grad_norm or 0.0,
                value_clip=self.max_value_grad_norm or 0.0)
            run_ppo_update(self.model.learner, obs, actions, old_log_probs,
                           advantages, returns, hp, self.n_epochs,
                           self.batch_size, rng, valid=valid, codes=codes)
            return
        # facade path appends trees outside the host counter's view
        self.model.learner._rl_host_n_trees = None
        n = len(obs)
        na = self.n_actions
        for _ in range(self.n_epochs):
            perm = rng.permutation(n)
            for start in range(0, n, self.batch_size):
                mb = perm[start:start + self.batch_size]
                mb = mb[valid[mb] > 0.5]      # drop autoreset rows
                if len(mb) < 2:
                    continue
                pol_full, val_full = self.model.learner.predict(
                    obs, requires_grad=False, tensor=False)   # cached + delta
                theta = th.tensor(pol_full[mb], requires_grad=True)
                values = th.tensor(val_full[mb], requires_grad=True)
                dist = Categorical(logits=theta)
                a = th.as_tensor(actions[mb])
                log_prob = dist.log_prob(a)
                adv = th.as_tensor(advantages[mb])
                if self.normalize_advantage:
                    adv = (adv - adv.mean()) / (adv.std() + 1e-8)
                ratio = th.exp(log_prob - th.as_tensor(old_log_probs[mb]))
                pg1 = adv * ratio
                pg2 = adv * th.clamp(ratio, 1 - self.clip_range,
                                     1 + self.clip_range)
                policy_loss = -th.min(pg1, pg2).mean()
                entropy_loss = -dist.entropy().mean()
                (policy_loss + self.ent_coef * entropy_loss).backward()
                value_loss = self.vf_coef * 0.5 * ((
                    th.as_tensor(returns[mb]) - values) ** 2).mean()
                value_loss.backward()
                nb = len(mb)
                self.model.step(
                    observations=obs[mb],
                    policy_grads=theta.grad.detach() * nb,
                    value_grads=values.grad.detach() * nb,
                    policy_grad_clip=self.max_policy_grad_norm,
                    value_grad_clip=self.max_value_grad_norm)

    # ---------------------------------------------------------------- learn
    def learn(self, total_timesteps: int, seed: int = 0):
        rng = np.random.default_rng(seed)
        G = len(self.env_groups)
        obs_list, dones_list = [], []
        for g, e in enumerate(self.env_groups):
            o, _ = e.reset(seed=seed + g * self.n_envs)
            obs_list.append(o)
            dones_list.append(np.zeros(self.n_envs, dtype=np.float32))
        num_dim, cat_dim = self.obs_dim, 0
        if self.categorical:
            lr = self.model.learner
            lr._infer_mapping_from(obs_list[0])
            num_dim, cat_dim = lr.cfg.n_num_features, lr.cfg.n_cat_features
        buffers = [RolloutBuffer(self.n_steps, self.n_envs, num_dim,
                                 self.gamma, self.gae_lambda, cat_dim)
                   for _ in range(G)]
        self._buffers = buffers   # final-rollout diagnostics (tests)
        # preallocate ensemble capacity for the whole run: one growth up
        # front instead of a reallocation at every power-of-two crossing
        rollout_rows = self.n_steps * self.n_envs * G
        iters_planned = -(-total_timesteps // rollout_rows)
        trees_per_update = self.n_epochs * (-(-rollout_rows
                                              // self.batch_size))
        from ..ensemble import ensure_capacity
        lr = self.model.learner
        if hasattr(lr, "ens") and lr.ens is not None:
            n0 = lr.get_num_trees()
            lr.ens = ensure_capacity(
                lr.ens, n0 + iters_planned * trees_per_update)
            # host-side tree counter: saves a device fetch per iteration
            # (jit_update.run_ppo_update maintains it)
            lr._rl_host_n_trees = n0
        self.curve = []           # per-iteration (steps, mean100, trees)
        steps = 0
        it = 0
        while steps < total_timesteps:
            # spans (utils/profiling.py): an ``iteration`` holds the
            # ``rollout``, the ``update`` and the mirror's sync
            with profiling.span("iteration", it=it):
                with profiling.span("rollout"):
                    if G == 1:
                        obs_list[0], dones_list[0] = self.collect_rollout(
                            buffers[0], obs_list[0], dones_list[0], rng)
                    else:
                        obs_list, dones_list = self.collect_rollout_pipelined(
                            buffers, obs_list, dones_list, rng)
                self.update(buffers, rng)
                if self._mirror:
                    self._mirror.sync()
            steps += self.n_steps * self.n_envs * G
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
