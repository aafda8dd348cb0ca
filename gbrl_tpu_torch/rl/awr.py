"""AWR (Advantage-Weighted Regression) with a GBT Gaussian actor and a GBT
value critic (counterpart of ``gbrl_tpu/rl/awr.py``, the JAX package's
BASELINE config 5: continuous control with a GaussianActor and a value
critic, feature weights supported).

AWR (Peng et al. 2019): the critic regresses returns; the actor maximizes
log pi(a|s) * exp(A / beta) over replayed experience.  The models live on
``device`` ("cuda" by default); rollouts and the replay's value estimates
are served on the host by the ensembles' mirrors (utils/host_mirror.py),
and each iteration's boosting steps run on the device as one loop
(rl/jit_awr.py, the default) or through the model facades
(``jit_update=False``).  The environment is any vector env with
gymnasium's interface (``num_envs``, ``single_observation_space.shape``,
``single_action_space.{low, high, shape}``, ``reset`` and ``step``); this
module does not import gymnasium.
"""
from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch as th
from torch.distributions import Normal

from ..models.actor import GaussianActor
from ..models.gbt import GBTModel
from ..utils import profiling


class AWR:
    def __init__(self, env, tree_struct: Dict = None, params: Dict = None,
                 actor_lr: float = 0.05, critic_lr: float = 0.5,
                 beta: float = 1.0, max_weight: float = 20.0,
                 n_steps: int = 2048, gamma: float = 0.99,
                 gae_lambda: float = 0.95,
                 actor_updates: int = 10, critic_updates: int = 10,
                 batch_size: int = 512, buffer_size: int = 50000,
                 log_std_init: float = -0.5, learn_std: bool = False,
                 log_std_final: Optional[float] = None,
                 max_actor_grad_norm: float = 10.0,
                 feature_weights=None,
                 log_interval: int = 0, device: str = "cuda",
                 jit_update: bool = True):
        self.env = env
        self.n_envs = env.num_envs
        obs_dim = int(np.prod(env.single_observation_space.shape))
        act_dim = int(np.prod(env.single_action_space.shape))
        self.obs_dim, self.act_dim = obs_dim, act_dim
        tree_struct = dict(tree_struct or dict(
            max_depth=4, n_bins=256, min_data_in_leaf=0, par_th=2,
            grow_policy="oblivious"))
        params = dict(params or dict(split_score_func="cosine",
                                     generator_type="Quantile"))
        if feature_weights is not None:
            params["feature_weights"] = feature_weights
        # fixed std by default: the weighted log-prob regression is
        # unstable in std (matching high-weight actions drives std -> 0,
        # exploding (a-mu)/std^2 gradients -> NaN policies); the reference
        # GaussianActor supports the same fixed-std mode (actor.py:359)
        std_opt = {"std_algo": "SGD", "std_lr": actor_lr * 0.1,
                   "start_idx": act_dim, "stop_idx": 2 * act_dim} \
            if learn_std else None
        self.learn_std = learn_std
        self.actor = GaussianActor(
            tree_struct=tree_struct, input_dim=obs_dim,
            output_dim=2 * act_dim if learn_std else act_dim,
            mu_optimizer={"mu_algo": "SGD", "mu_lr": actor_lr,
                          "start_idx": 0, "stop_idx": act_dim},
            std_optimizer=std_opt,
            log_std_init=log_std_init, params=params, device=device)
        self.critic = GBTModel(
            tree_struct=tree_struct, input_dim=obs_dim, output_dim=1,
            optimizers={"algo": "SGD", "lr": critic_lr, "start_idx": 0,
                        "stop_idx": 1}, params=params, device=device)
        self.beta = beta
        self.max_weight = max_weight
        self.max_actor_grad_norm = max_actor_grad_norm
        self.log_std_final = log_std_final
        self._progress = 0.0      # training fraction, for the sigma anneal
        self.n_steps = n_steps
        self.gamma = gamma
        self.gae_lambda = gae_lambda
        self.actor_updates = actor_updates
        self.critic_updates = critic_updates
        self.batch_size = batch_size
        self.buffer_size = buffer_size
        self.log_interval = log_interval
        self.jit_update = jit_update
        self.episode_rewards = []
        self._ep_ret = np.zeros(self.n_envs, dtype=np.float64)
        self._replay = []   # list of (obs, act, ret) batches
        self._vcache = []   # per-chunk incremental V(s)/V(s') caches

    # ----------------------------------------------------------- host mirror
    def _get_mirrors(self):
        """Host-resident ensemble mirrors (utils/host_mirror.py) serving
        per-env-step actor forwards and critic bootstrap values in
        microseconds instead of a device round trip per step."""
        if not hasattr(self, "_mirrors"):
            from ..utils.host_mirror import HostMirror
            alr, clr = self.actor.learner, self.critic.learner
            ok = (all(s.algo == "SGD" for s in alr.specs)
                  and all(s.algo == "SGD" for s in clr.specs)
                  and alr.vocab is None)
            self._mirrors = (HostMirror(alr), HostMirror(clr)) if ok else None
        return self._mirrors

    def _sync_mirrors(self):
        m = self._get_mirrors()
        if m:
            m[0].sync()
            m[1].sync()

    def _sample_log_std(self) -> float:
        """Exploration sigma for fixed-std sampling; linearly annealed to
        ``log_std_final`` over training when set (persistent exploration
        noise costs reward in the endgame, e.g. sigma 0.6 torque noise on
        Pendulum wobbles the balanced pole)."""
        ls = self.actor.log_std_init
        if self.log_std_final is not None:
            ls = ls + (self.log_std_final - ls) * min(self._progress, 1.0)
        return ls

    def _act(self, obs: np.ndarray, rng, span=profiling.span):
        m = self._get_mirrors()
        if m:
            # numpy sampling: torch per-op overhead dominates tiny rollout
            # batches (see rl/ppo.py _sample_np)
            with span("mirror.forward", rows=len(obs)):
                theta = m[0].predict(np.asarray(obs, dtype=np.float32))
            A = self.act_dim
            mu = theta[:, :A]
            log_std = np.clip(theta[:, A:], -2.5, 0.5) if self.learn_std \
                else np.full_like(mu, self._sample_log_std())
            return mu + np.exp(log_std) * rng.standard_normal(
                mu.shape).astype(np.float32)
        mu, log_std = self.actor(obs, requires_grad=False)
        if not self.learn_std:
            # fixed-sigma mode: the anneal applies on every sampling path
            # (mirror and facade alike)
            log_std = th.full_like(mu, self._sample_log_std())
        a = Normal(mu, th.exp(log_std)).sample()
        return a.cpu().numpy()

    def _values(self, obs: np.ndarray) -> np.ndarray:
        m = self._get_mirrors()
        if m:
            with profiling.span("mirror.forward", rows=len(obs)):
                return m[1].predict(np.asarray(obs, dtype=np.float32)
                                    ).reshape(-1)
        return np.asarray(self.critic(obs, requires_grad=False,
                                      tensor=False)).reshape(-1)

    def _rollout(self, obs, rng):
        """Collect n_steps transitions under gymnasium >=1.0 NextStep
        autoreset semantics: the observation returned WITH a done flag is
        the episode's FINAL observation (used to bootstrap truncations),
        and the following step() call resets that env ignoring the action;
        that row is recorded with valid=0 and excluded from training."""
        E = self.n_envs
        O, NO, A, R, Term, Trunc, Valid = [], [], [], [], [], [], []
        prev_done = self._prev_done
        low = self.env.single_action_space.low
        high = self.env.single_action_space.high
        span = profiling.spanner()
        for _ in range(self.n_steps // E):
            a_clip = np.clip(self._act(obs, rng, span), low, high)
            next_obs, rew, term, trunc, _ = self.env.step(a_clip)
            done = np.logical_or(term, trunc)
            O.append(obs); NO.append(next_obs); A.append(a_clip); R.append(rew)
            Term.append(term.astype(np.float32))
            Trunc.append(trunc.astype(np.float32))
            Valid.append(1.0 - prev_done.astype(np.float32))
            self._ep_ret += np.where(prev_done, 0.0, rew)
            for i in range(E):
                if done[i] and not prev_done[i]:
                    self.episode_rewards.append(self._ep_ret[i])
                    self._ep_ret[i] = 0.0
            prev_done = done
            obs = next_obs
        self._prev_done = prev_done
        return (np.asarray(O, dtype=np.float32),
                np.asarray(NO, dtype=np.float32),
                np.asarray(A, np.float32),
                np.asarray(R, np.float32), np.asarray(Term, np.float32),
                np.asarray(Trunc, np.float32),
                np.asarray(Valid, np.float32), obs)

    def _recompute_replay(self):
        """TD(lambda) advantages + value targets over the WHOLE replay with
        the CURRENT critic (AWR paper Algorithm 1 recomputes both every
        iteration; stale advantages from an old critic rank samples by
        critic drift instead of action quality).

        Per transition: delta = r + gamma * (1 - term) * V(s') - V(s)
        (truncations bootstrap through V(s'), which IS the final
        observation under NextStep autoreset; terminations cut), then
        GAE(lambda) chained within each chunk, target = adv + V(s).
        Served by the host mirror with INCREMENTAL value caches: each
        chunk's V(s)/V(s') arrays are cached and only the trees fitted
        since the last recompute are added (HostMirror.predict_range), so
        the per-iteration cost is O(replay * new_trees) instead of
        O(replay * total_trees)."""
        obs_l, act_l, ret_l, adv_l = [], [], [], []
        m = self._get_mirrors()
        cm = m[1] if m else None
        span = profiling.spanner()
        for ci, (O, NO, A, R, Term, Trunc, Valid) in enumerate(self._replay):
            T, E = R.shape
            if cm is not None:
                cache = self._vcache[ci]
                t_now = cm.n_synced
                if cache is None or not np.array_equal(cache["bias"],
                                                       cm.bias):
                    with span("mirror.range", rows=2 * T * E, trees=t_now):
                        cache = dict(
                            v=cm.predict(O.reshape(T * E, -1))[:, 0].copy(),
                            vn=cm.predict(NO.reshape(T * E, -1))[:, 0].copy(),
                            t=t_now, bias=cm.bias.copy())
                    self._vcache[ci] = cache
                elif cache["t"] < t_now:
                    with span("mirror.range", rows=2 * T * E,
                              trees=t_now - cache["t"]):
                        cache["v"] += cm.predict_range(
                            O.reshape(T * E, -1), cache["t"], t_now)[:, 0]
                        cache["vn"] += cm.predict_range(
                            NO.reshape(T * E, -1), cache["t"], t_now)[:, 0]
                    cache["t"] = t_now
                v = cache["v"].reshape(T, E)
                vn = cache["vn"].reshape(T, E)
            else:
                v = self._values(O.reshape(T * E, -1)).reshape(T, E)
                vn = self._values(NO.reshape(T * E, -1)).reshape(T, E)
            delta = R + self.gamma * (1.0 - Term) * vn - v
            adv = np.zeros_like(R)
            gae = np.zeros(E, dtype=np.float32)
            done = np.maximum(Term, Trunc)
            for t in reversed(range(T)):
                gae = delta[t] + self.gamma * self.gae_lambda \
                    * (1.0 - done[t]) * gae
                adv[t] = gae
            keep = Valid.reshape(-1) > 0.5
            obs_l.append(O.reshape(T * E, -1)[keep])
            act_l.append(A.reshape(T * E, -1)[keep])
            ret_l.append((adv + v).reshape(-1)[keep])
            adv_l.append(adv.reshape(-1)[keep])
        return (np.concatenate(obs_l), np.concatenate(act_l),
                np.concatenate(ret_l), np.concatenate(adv_l))

    def _update_facade(self, r_obs, r_act, r_ret, r_adv, rng) -> None:
        """One iteration's boosting steps through the model facades."""
        dev = self.actor.learner.torch_device
        # critic updates: one tree per minibatch regression step
        for _ in range(self.critic_updates):
            mb = rng.integers(0, len(r_obs), self.batch_size)
            v = self.critic(r_obs[mb], requires_grad=True)
            loss = 0.5 * ((v - th.as_tensor(r_ret[mb], device=dev)) ** 2
                          ).mean()
            loss.backward()
            self.critic.step()
        # actor updates: advantage-weighted log-prob regression with
        # batch-standardized advantages (raw return scales saturate the
        # exponential weights otherwise)
        for _ in range(self.actor_updates):
            mb = rng.integers(0, len(r_obs), self.batch_size)
            adv = r_adv[mb]
            adv = (adv - adv.mean()) / (adv.std() + 1e-8)
            w = np.exp(np.minimum(adv / self.beta, np.log(self.max_weight)))
            mu, log_std = self.actor(r_obs[mb], requires_grad=True)
            wt = th.as_tensor(w, dtype=th.float32, device=dev)
            at = th.as_tensor(r_act[mb], device=dev)
            # sigma^2-free weighted regression for mu (see rl/jit_awr.py)
            loss = (wt * 0.5 * ((at - mu) ** 2).sum(-1)).mean()
            if self.learn_std:
                log_std = th.clamp(log_std, -2.5, 0.5)
                z = (at - mu.detach()) / th.exp(log_std)
                loss = loss + (wt * (log_std + 0.5 * z ** 2).sum(-1)).mean()
            loss.backward()
            gc = self.max_actor_grad_norm or None
            self.actor.step(mu_grad_clip=gc, log_std_grad_clip=gc)

    def learn(self, total_timesteps: int, seed: int = 0):
        rng = np.random.default_rng(seed)
        obs, _ = self.env.reset(seed=seed)
        self._prev_done = np.zeros(self.n_envs, dtype=bool)
        self.curve = []
        # preallocate capacity for the whole run: one growth up front
        # instead of a reallocation at every power-of-two crossing
        from ..ensemble import ensure_capacity
        iters_planned = -(-total_timesteps // self.n_steps)
        for model, per_iter in ((self.actor, self.actor_updates),
                                (self.critic, self.critic_updates)):
            lr = model.learner
            n0 = lr.get_num_trees()
            lr.ens = ensure_capacity(lr.ens, n0 + iters_planned * per_iter)
            lr._rl_host_n_trees = n0
        steps, it = 0, 0
        while steps < total_timesteps:
            # spans (utils/profiling.py): an ``iteration`` holds the
            # ``rollout``, the ``replay`` recomputes, the ``update`` and the
            # mirrors' syncs
            with profiling.span("iteration", it=it):
                with profiling.span("rollout"):
                    chunk = self._rollout(obs, rng)
                obs = chunk[-1]
                self._replay.append(chunk[:-1])
                self._vcache.append(None)
                total = sum(x[3].size for x in self._replay)
                while total > self.buffer_size and len(self._replay) > 1:
                    total -= self._replay.pop(0)[3].size
                    self._vcache.pop(0)
                if it == 0:
                    # jump the critic to the return scale at once (reference
                    # GBTModel.set_bias_from_targets, gbt.py:130-148)
                    with profiling.span("replay"):
                        _, _, ret0, _ = self._recompute_replay()
                    self.critic.set_bias_from_targets(ret0.reshape(-1, 1))
                    self._sync_mirrors()
                with profiling.span("replay"):
                    r_obs, r_act, r_ret, r_adv = self._recompute_replay()
                if self.jit_update and self.actor.learner.vocab is None:
                    # every critic and actor boosting step of this iteration
                    # in one loop on the device (rl/jit_awr.py)
                    from .jit_awr import run_awr_update
                    run_awr_update(self, r_obs, r_act, r_ret, rng, r_adv)
                else:
                    self._update_facade(r_obs, r_act, r_ret, r_adv, rng)
                self._sync_mirrors()
            steps += self.n_steps
            it += 1
            self._progress = steps / max(total_timesteps, 1)
            ntr = self.actor.learner._rl_host_n_trees
            if ntr is None:
                ntr = self.actor.get_num_trees()
            self.curve.append(dict(
                steps=steps, mean_reward_100=self.mean_reward(), trees=ntr))
            if self.log_interval and it % self.log_interval == 0:
                mean100 = (np.mean(self.episode_rewards[-100:])
                           if self.episode_rewards else float("nan"))
                print(f"iter {it} steps {steps} actor_trees "
                      f"{ntr} ep_rew_mean {mean100:.1f}")
        return self

    def mean_reward(self, last: int = 100) -> float:
        if not self.episode_rewards:
            return float("nan")
        return float(np.mean(self.episode_rewards[-last:]))
