"""SAC (Soft Actor-Critic) with a GBT tanh-Gaussian actor and twin GBT
parametric Q-critics (counterpart of ``gbrl_tpu/rl/sac.py``).

EXPERIMENTAL, as in the JAX package: it learns contextual-bandit tasks and
runs at full speed, but does not solve Pendulum at small tree budgets.

The reference ships the model pieces for SAC (``GaussianActor`` and
``ContinuousCritic`` with its three parametric Q-forms, reference
gbrl/models/critic.py:42-54):

    linear     Q(theta(s), a) = <w, a> + b
    quadratic  Q(theta(s), a) = -(<w, a> - b)^2 + c
    tanh       Q(theta(s), a) = b * tanh(<w, a>)

but delegates the algorithm to its companion repo GBRL_SB3 (reference
README.md:19).  The critic trees output Q *parameters* theta(s), so dQ/da
exists analytically while theta follows boosted-tree updates, and the
target network is the ensemble prefix (critic.py:165-193): no polyak
averaging, just older trees.

The models live on ``device`` ("cuda" by default).  Actions are served on
the host by the actor's mirror (utils/host_mirror.py); each gradient step
runs on the device as one fused step (rl/jit_sac.py, the default) or
through the model facades (``jit_train=False``), where forward passes return
torch leaf tensors, a scalar loss is backpropagated, and ``model.step()``
turns ``param.grad * n`` into one boosting iteration.  The environment is
any vector env with gymnasium's interface (``num_envs``,
``single_observation_space.shape``, ``single_action_space.{low, high,
shape}``, ``reset`` and ``step``); this module does not import gymnasium.
"""
from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch as th
from torch.distributions import Normal

from ..models.actor import GaussianActor
from ..models.critic import ContinuousCritic
from ..utils import profiling
from .buffers import NStepAccumulator, ReplayBuffer

LOG_STD_MIN, LOG_STD_MAX = -20.0, 2.0


def q_param_dim(q_func_type: str, act_dim: int) -> int:
    """Number of tree output columns for each Q-form (w block + scalar
    tail)."""
    return act_dim + (2 if q_func_type == "quadratic" else 1)


def q_from_params(w: th.Tensor, b: th.Tensor, actions: th.Tensor,
                  q_func_type: str) -> th.Tensor:
    """Evaluate Q(theta(s), a) for the given parametric form.

    w: [N, act_dim] weights; b: [N, 1] (linear/tanh) or [N, 2] (quadratic);
    actions: [N, act_dim].  Returns [N]."""
    s = (w * actions).sum(-1)
    if q_func_type == "linear":
        return s + b[:, 0]
    if q_func_type == "quadratic":
        return -((s - b[:, 0]) ** 2) + b[:, 1]
    if q_func_type == "tanh":
        return b[:, 0] * th.tanh(s)
    raise ValueError(f"unknown q_func_type: {q_func_type}")


def squashed_gaussian_sample(mu: th.Tensor, log_std: th.Tensor,
                             eps: th.Tensor):
    """Reparameterized tanh-squashed Gaussian: a = tanh(mu + std*eps).

    Returns (action in (-1,1), log-prob with the tanh Jacobian correction)."""
    log_std = th.clamp(log_std, LOG_STD_MIN, LOG_STD_MAX)
    std = th.exp(log_std)
    u = mu + std * eps
    a = th.tanh(u)
    logp = Normal(mu, std).log_prob(u).sum(-1)
    logp = logp - th.log(1.0 - a ** 2 + 1e-6).sum(-1)
    return a, logp


class SAC:
    """Soft Actor-Critic over vector envs with continuous actions.

    Actions are squashed to (-1, 1) and rescaled to the env action bounds.
    """

    def __init__(self, env, tree_struct: Dict = None, params: Dict = None,
                 actor_lr=0.02, critic_lr=0.05,
                 bias_lr=None, schedule_T: Optional[int] = None,
                 q_func_type: str = "linear", n_critics: int = 2,
                 buffer_size: int = 100_000, batch_size: int = 256,
                 gamma: float = 0.99, n_step: int = 1,
                 learning_starts: int = 1000,
                 train_freq: int = 4, gradient_steps: int = 1,
                 target_update_interval: int = 100,
                 ent_coef="auto", target_entropy: Optional[float] = None,
                 log_std_init: float = -1.0, max_grad_norm: float = 10.0,
                 log_interval: int = 0, device: str = "cuda",
                 jit_train: bool = True):
        self.env = env
        self.n_envs = env.num_envs
        obs_dim = int(np.prod(env.single_observation_space.shape))
        act_dim = int(np.prod(env.single_action_space.shape))
        self.obs_dim, self.act_dim = obs_dim, act_dim
        self.q_func_type = q_func_type
        low = np.asarray(env.single_action_space.low, dtype=np.float32)
        high = np.asarray(env.single_action_space.high, dtype=np.float32)
        self._act_scale = (high - low) / 2.0
        self._act_center = (high + low) / 2.0

        tree_struct = dict(tree_struct or dict(
            max_depth=4, n_bins=256, min_data_in_leaf=0, par_th=2,
            grow_policy="oblivious"))
        params = dict(params or dict(split_score_func="cosine",
                                     generator_type="Quantile"))

        # lrs may be floats or the reference's "lin_<lr>" strings (Linear
        # scheduler annealing init_lr -> stop_lr over schedule_T trees): the
        # anneal cures late-run overwrite churn in long off-policy runs
        def _scale_lr(lr, f):
            if isinstance(lr, str):
                assert lr.startswith("lin_"), lr
                return f"lin_{float(lr[4:]) * f}"
            return lr * f

        def _opt(prefix, lr, start, stop):
            d = {f"{prefix}algo": "SGD", f"{prefix}lr": lr,
                 "start_idx": start, "stop_idx": stop}
            if isinstance(lr, str):
                assert schedule_T, "lin_ lrs need schedule_T (planned trees)"
                d["T"] = int(schedule_T)
            return d

        self.actor = GaussianActor(
            tree_struct=tree_struct, input_dim=obs_dim,
            output_dim=2 * act_dim,
            mu_optimizer=_opt("mu_", actor_lr, 0, act_dim),
            std_optimizer=_opt("std_", _scale_lr(actor_lr, 0.1),
                               act_dim, 2 * act_dim),
            log_std_init=log_std_init, params=params, device=device)

        qdim = q_param_dim(q_func_type, act_dim)
        bias_lr = bias_lr if bias_lr is not None else critic_lr
        # Start the w-block at 1 (not 0): at w = b = 0 the quadratic and
        # tanh forms sit on a saddle where dQ/dw = dQ/db = 0 identically,
        # so the per-sample leaf gradients would stay zero forever.
        critic_bias = np.zeros(qdim, dtype=np.float32)
        critic_bias[:act_dim] = 1.0
        self.critics = [
            ContinuousCritic(
                tree_struct=tree_struct, input_dim=obs_dim, output_dim=qdim,
                bias=critic_bias.copy(),
                weights_optimizer=_opt("weights_", critic_lr, 0, act_dim),
                bias_optimizer=_opt("bias_", bias_lr, act_dim, qdim),
                params=params,
                target_update_interval=target_update_interval,
                device=device)
            for _ in range(n_critics)]

        self.gamma = gamma
        # n-step TD targets: each target carries n real rewards and a
        # gamma^n-discounted tail, which moves the critic's value head
        # faster at tree-budget pace than 1-step bootstrapping
        self.n_step = int(n_step)
        self.batch_size = batch_size
        self.learning_starts = learning_starts
        self.train_freq = train_freq
        self.gradient_steps = gradient_steps
        self.max_grad_norm = max_grad_norm
        self.log_interval = log_interval
        self.jit_train = jit_train
        self._train_gen = None   # the fused step's noise, on the device
        self.buffer = ReplayBuffer(buffer_size, obs_dim, act_dim)
        self._nstep = NStepAccumulator(self.n_envs, self.n_step, gamma)

        self.target_entropy = (float(target_entropy)
                               if target_entropy is not None
                               else -float(act_dim))
        self.auto_alpha = isinstance(ent_coef, str)
        if self.auto_alpha:
            # "auto" or "auto_<init>"; boosted-tree budgets are short, so
            # default the initial temperature low (0.1) vs SB3's 1.0
            init = float(ent_coef.split("_")[1]) if "_" in ent_coef else 0.1
            self.log_alpha = th.tensor([np.log(init)], dtype=th.float32,
                                       requires_grad=True)
            self.alpha_opt = th.optim.Adam([self.log_alpha], lr=3e-3)
        else:
            self.log_alpha = th.log(th.as_tensor([float(ent_coef)]))

        self.episode_rewards = []
        self._ep_ret = np.zeros(self.n_envs, dtype=np.float64)
        self._mirror = None
        self._critic_bias_set = False

    @property
    def alpha(self) -> float:
        return float(self.log_alpha.exp().detach())

    @property
    def _device(self) -> th.device:
        return self.actor.learner.torch_device

    # ----------------------------------------------------------- host mirror
    def _get_mirror(self):
        """Host-resident actor mirror serving per-env-step forwards in
        microseconds (utils/host_mirror.py) instead of a device round trip
        per step, the same split as rl/ppo.py / rl/awr.py."""
        if self._mirror is None:
            lr = self.actor.learner
            ok = (all(s.algo == "SGD" for s in lr.specs)
                  and lr.vocab is None and lr.ens is not None)
            if ok:
                from ..utils.host_mirror import HostMirror
                self._mirror = HostMirror(lr)
            else:
                self._mirror = False
        return self._mirror or None

    # ---------------------------------------------------------------- acting
    def _policy_sample(self, obs: np.ndarray, gen: th.Generator,
                       requires_grad: bool):
        """Facade forward + a reparameterized sample; the noise comes from
        the host generator ``gen`` (as the JAX package's facade)."""
        mu, log_std = self.actor(obs, requires_grad=requires_grad)
        eps = th.randn(mu.shape, generator=gen).to(mu.device)
        return squashed_gaussian_sample(mu, log_std, eps)

    def _act(self, obs: np.ndarray, gen: th.Generator,
             deterministic: bool = False,
             span=profiling.span) -> np.ndarray:
        mirror = self._get_mirror()
        if mirror is not None:
            # mirror predictions include the ensemble bias (log_std_init
            # tail included), same as rl/awr.py _act
            with span("mirror.forward", rows=len(obs)):
                theta = mirror.predict(np.asarray(obs, dtype=np.float32))
            A = self.act_dim
            mu = theta[:, :A]
            if deterministic:
                return np.tanh(mu)
            log_std = np.clip(theta[:, A:], LOG_STD_MIN, LOG_STD_MAX)
            eps = th.randn(mu.shape, generator=gen).numpy()
            return np.tanh(mu + np.exp(log_std) * eps).astype(np.float32)
        with th.no_grad():
            mu, log_std = self.actor(obs, requires_grad=False)
            if deterministic:
                a = th.tanh(mu)
            else:
                eps = th.randn(mu.shape, generator=gen).to(mu.device)
                a, _ = squashed_gaussian_sample(mu, log_std, eps)
        return a.cpu().numpy()

    def _env_action(self, a: np.ndarray) -> np.ndarray:
        return a * self._act_scale + self._act_center

    # -------------------------------------------------------------- updates
    def _target_q(self, next_obs: np.ndarray, gen: th.Generator) -> th.Tensor:
        with th.no_grad():
            na, nlogp = self._policy_sample(next_obs, gen,
                                            requires_grad=False)
            qs = []
            for c in self.critics:
                w, b = c.predict_target(next_obs)
                w = w.reshape(len(next_obs), -1)
                b = b.reshape(len(next_obs), -1)
                qs.append(q_from_params(w, b, na, self.q_func_type))
            qmin = th.stack(qs, 0).min(0).values
            return qmin - self.alpha * nlogp

    def update_critics(self, obs, actions, target) -> float:
        """One boosting step per critic on 0.5*(Q - target)^2. Returns loss."""
        dev = self._device
        actions_t = th.as_tensor(actions, dtype=th.float32, device=dev)
        target_t = th.as_tensor(target, dtype=th.float32, device=dev)
        losses = []
        for c in self.critics:
            w, b = c(obs, requires_grad=True)
            w = w.reshape(len(obs), -1)
            b = b.reshape(len(obs), -1)
            q = q_from_params(w, b, actions_t, self.q_func_type)
            loss = 0.5 * ((q - target_t) ** 2).mean()
            loss.backward()
            c.step(q_grad_clip=self.max_grad_norm)
            losses.append(float(loss.detach()))
        return float(np.mean(losses))

    def update_actor(self, obs, gen: th.Generator) -> float:
        """One boosting step on E[alpha*logp - min_i Q_i(s, a(s))]."""
        a, logp = self._policy_sample(obs, gen, requires_grad=True)
        qs = []
        for c in self.critics:
            with th.no_grad():
                w, b = c(obs, requires_grad=False)
                w = w.reshape(len(obs), -1)
                b = b.reshape(len(obs), -1)
            qs.append(q_from_params(w, b, a, self.q_func_type))
        qmin = th.stack(qs, 0).min(0).values
        loss = (self.alpha * logp - qmin).mean()
        loss.backward()
        self.actor.step(mu_grad_clip=self.max_grad_norm,
                        log_std_grad_clip=self.max_grad_norm)
        if self.auto_alpha:
            self.alpha_opt.zero_grad()
            alpha_loss = -(self.log_alpha
                           * (logp.detach().cpu() + self.target_entropy)
                           ).mean()
            alpha_loss.backward()
            self.alpha_opt.step()
        return float(loss.detach())

    def train_step(self, gen: th.Generator, rng) -> Dict[str, float]:
        obs, actions, rewards, next_obs, dones, discs = \
            self.buffer.sample(self.batch_size, rng)
        if self.jit_train:
            # fused device step: one host synchronisation
            from .jit_sac import run_sac_train_step
            if self._train_gen is None:
                self._train_gen = th.Generator(device=self._device)
                self._train_gen.manual_seed(
                    int(gen.initial_seed()) & 0x7FFFFFFF)
            info = run_sac_train_step(self, obs, actions, rewards, next_obs,
                                      dones, discs, self._train_gen)
            info["alpha"] = self.alpha
            return info
        dev = self._device
        y = (th.as_tensor(rewards, device=dev)
             + th.as_tensor(discs, device=dev)
             * th.as_tensor(1.0 - dones, device=dev)
             * self._target_q(next_obs, gen))
        closs = self.update_critics(obs, actions, y.cpu().numpy())
        aloss = self.update_actor(obs, gen)
        return {"critic_loss": closs, "actor_loss": aloss,
                "alpha": self.alpha}

    # --------------------------------------------------------------- driver
    def _jump_critic_bias(self) -> None:
        """Jump the critics' value scale at once (the GBT analogue of AWR's
        set_bias_from_targets): the scalar tail of theta starts at 0 while
        V is O(r_mean / (1 - gamma)), a gap that bootstrapping closes only
        over thousands of trees.  Geometric-series scale with the observed
        terminal rate: v0 = r_mean for bandits (d = 1), r / (1 - gamma^n)
        for continuing tasks (d = 0); rewards are n-step sums and discs
        gamma^k, so the same fixed point applies."""
        n0 = len(self.buffer)
        r_mean = float(np.mean(self.buffer.rewards[:n0]))
        d_mean = float(np.mean(self.buffer.dones[:n0]))
        g_mean = float(np.mean(self.buffer.discs[:n0]))
        v0 = r_mean / max(1.0 - g_mean * (1.0 - d_mean), 1e-3)
        for c in self.critics:
            # a read of the bias and a copy from pageable memory
            profiling.count_sync("sac_bias", self._device.type == "cuda", 2)
            b = np.asarray(c.learner.get_bias(), dtype=np.float32).copy()
            b[-1] = v0
            c.learner.set_bias(b)
        self._critic_bias_set = True

    def _rollout(self, obs: np.ndarray, total_timesteps: int, rng,
                 gen: th.Generator) -> np.ndarray:
        """One train event's vector env steps: up to ``train_freq`` of
        them, fewer where the run's total ends first.  Uniform actions
        before ``learning_starts``, the actor's mirror after; valid rows
        feed the per-env n-step accumulator and the replay.  Returns the
        last observations; the event's observations and actions stay in
        ``_last_rollout``."""
        span = profiling.spanner()
        O, Acts = [], []
        prev_done = self._prev_done
        while self._steps < total_timesteps:
            if self._steps < self.learning_starts:
                a = rng.uniform(-1.0, 1.0,
                                (self.n_envs, self.act_dim)
                                ).astype(np.float32)
            else:
                a = self._act(obs, gen, span=span)
            next_obs, rew, term, trunc, _ = self.env.step(self._env_action(a))
            done = np.logical_or(term, trunc)
            O.append(obs)
            Acts.append(a)
            # NextStep autoreset: the step after an episode end returns the
            # reset obs with reward 0 and an ignored action; that transition
            # must not enter the replay.  Valid rows feed the per-env n-step
            # accumulator; truncation is not a true terminal (the
            # accumulator flushes with done=0 so targets bootstrap through
            # the episode's final observation)
            emitted = []
            for i in range(self.n_envs):
                if prev_done[i]:
                    continue
                emitted += self._nstep.add(i, obs[i], a[i], float(rew[i]),
                                           next_obs[i], bool(term[i]),
                                           bool(trunc[i]))
            if emitted:
                self.buffer.add(
                    np.stack([e[0] for e in emitted]),
                    np.stack([e[1] for e in emitted]),
                    np.asarray([e[2] for e in emitted], dtype=np.float32),
                    np.stack([e[3] for e in emitted]),
                    np.asarray([e[4] for e in emitted], dtype=np.float32),
                    np.asarray([e[5] for e in emitted], dtype=np.float32))
            self._ep_ret += np.where(prev_done, 0.0, rew)
            for i in range(self.n_envs):
                if done[i] and not prev_done[i]:
                    self.episode_rewards.append(self._ep_ret[i])
                    self._ep_ret[i] = 0.0
            prev_done = done
            obs = next_obs
            self._steps += self.n_envs
            self._it += 1
            if (self._steps >= self.learning_starts
                    and not self._critic_bias_set
                    and len(self.buffer) >= self.batch_size):
                self._jump_critic_bias()
            if self._it % self.train_freq == 0:
                break
        self._prev_done = prev_done
        self._last_rollout = (np.asarray(O, np.float32),
                              np.asarray(Acts, np.float32))
        return obs

    def _train(self, gen: th.Generator, rng) -> Dict[str, float]:
        """One train event's ``gradient_steps`` steps; returns the last
        step's statistics."""
        with profiling.span("update", algo="sac"):
            for _ in range(self.gradient_steps):
                info = self.train_step(gen, rng)
        return info

    def _sync_mirror(self) -> None:
        if self._get_mirror() is not None:
            self._mirror.sync()

    def learn(self, total_timesteps: int, seed: int = 0):
        rng = np.random.default_rng(seed)
        gen = th.Generator().manual_seed(seed)
        # the envs reset below: windows still pending from an earlier run
        # would join its (obs, action) pairs to this run's rewards
        self._nstep = NStepAccumulator(self.n_envs, self.n_step, self.gamma)
        self.curve = []           # per train event (steps, mean100, trees)
        # preallocate ensemble capacity for the whole run: one growth up
        # front instead of a reallocation at every power-of-two crossing
        from ..ensemble import ensure_capacity
        planned = (total_timesteps // max(self.n_envs * self.train_freq, 1)
                   + 1) * self.gradient_steps
        for model in [self.actor] + self.critics:
            lr = model.learner
            n0 = lr.get_num_trees()
            lr.ens = ensure_capacity(lr.ens, n0 + planned)
            lr._rl_host_n_trees = n0
        obs, _ = self.env.reset(seed=seed)
        self._prev_done = np.zeros(self.n_envs, dtype=bool)
        self._steps, self._it = 0, 0
        event = 0
        while self._steps < total_timesteps:
            # spans (utils/profiling.py): an ``iteration`` holds the
            # ``rollout``, the ``update`` and the mirror's sync
            with profiling.span("iteration", it=event):
                with profiling.span("rollout"):
                    obs = self._rollout(obs, total_timesteps, rng, gen)
                trained = (self._steps >= self.learning_starts
                           and self._it % self.train_freq == 0
                           and len(self.buffer) >= self.batch_size)
                if trained:
                    info = self._train(gen, rng)
                    self._sync_mirror()
            event += 1
            self.curve.append(dict(
                steps=self._steps, mean_reward_100=self.mean_reward(),
                trees=self.actor.learner._rl_host_n_trees))
            if (trained and self.log_interval
                    and self._it % self.log_interval == 0):
                mean100 = (np.mean(self.episode_rewards[-100:])
                           if self.episode_rewards else float("nan"))
                print(f"steps {self._steps} trees "
                      f"{self.actor.get_num_trees()} "
                      f"ep_rew_mean {mean100:.1f} "
                      f"closs {info['critic_loss']:.3f} "
                      f"alpha {info['alpha']:.3f}")
        return self

    def mean_reward(self, last: int = 100) -> float:
        if not self.episode_rewards:
            return float("nan")
        return float(np.mean(self.episode_rewards[-last:]))
