"""The SAC train step on the card: target computation, both critic boosting
steps and the actor boosting step as one run of device work (counterpart of
``gbrl_tpu/rl/jit_sac.py``).

The facade path (rl/sac.py ``train_step`` with ``jit_train=False``) reads
losses and gradients back to the host several times per gradient step.
This step copies one minibatch to the device, queues every launch, and
reads back only the three statistics the host needs for the (CPU torch)
temperature update: one host synchronisation per train step, where the JAX
package does ``jax.device_get(stats)``.

``sac_train_step`` computes the target as an eager head, through this
module's ``predict_sgd``, then runs the boosting body of ``_SACGraphs``
once through ``rl/graphs.py`` ``run_step``: the body reads static device
buffers and predicts over a working copy of each learner's ensemble (K5),
writing each new tree into that copy in place; after it ``write_tree``
hands each copy's new tree to its learner's ensemble.  On a CUDA device
the body is a replay of its captured CUDA graph; elsewhere it is called.

Semantics follow rl/sac.py exactly: the same order (critics first, the
actor against the UPDATED critics), the same tanh-Gaussian log-prob, the
same parametric Q-forms (reference gbrl/models/critic.py:42-54), the same
per-sample-block gradient clipping and the same ensemble-prefix targets
(critic.py:165-193).  The noise comes in as two tensors instead of a JAX
key; ``run_sac_train_step`` draws them from a ``torch.Generator`` on the
learners' device.
"""
from __future__ import annotations

import math
from typing import NamedTuple, Sequence, Tuple

import numpy as np
import torch

from ..config import TreeConfig
from ..ensemble import FIELDS, Ensemble, ensure_capacity
from ..ops import fit
from ..ops.boosting import (_TREE_FIELDS, _masked_candidates, predict_sgd,
                            write_tree)
from ..ops.candidates import bucketize
from ..ops.fit import build_tree, standardize_l2
from ..optimizers import OptimizerSpec
from ..utils import profiling
from . import graphs
from .jit_update import _block_clip

LOG_STD_MIN, LOG_STD_MAX = -20.0, 2.0
STATS = ("critic_loss", "actor_loss", "logp_mean")


class SACHyper(NamedTuple):
    """SAC hyperparameters.  The bootstrap discount is not here: it rides
    per sample (``discs`` = gamma^k for k-step transitions,
    rl/buffers.NStepAccumulator)."""
    act_dim: int
    q_func_type: str      # 'linear' | 'quadratic' | 'tanh'
    max_grad_norm: float  # 0.0 = off


def clip_as_jax(x: torch.Tensor, lo: float, hi: float) -> torch.Tensor:
    """``jnp.clip``: the same values as ``torch.clamp``, and the same
    gradient as JAX's, which is 1 inside, 0 outside and 1/2 on a bound
    (``torch.clamp`` passes 1 there; ``torch.maximum`` / ``minimum`` split
    a tie as JAX's max / min do)."""
    lo_t = torch.full((), lo, dtype=x.dtype, device=x.device)
    hi_t = torch.full((), hi, dtype=x.dtype, device=x.device)
    return torch.minimum(torch.maximum(x, lo_t), hi_t)


def q_torch(w: torch.Tensor, b: torch.Tensor, a: torch.Tensor,
            qtype: str) -> torch.Tensor:
    """Q(theta, a) for the parametric forms (rl/sac.q_from_params)."""
    s = torch.sum(w * a, dim=-1)
    if qtype == "linear":
        return s + b[:, 0]
    if qtype == "quadratic":
        return -((s - b[:, 0]) ** 2) + b[:, 1]
    if qtype == "tanh":
        return b[:, 0] * torch.tanh(s)
    raise ValueError(qtype)


def sample_squashed(mu: torch.Tensor, log_std: torch.Tensor,
                    eps: torch.Tensor):
    """a = tanh(mu + std * eps) and its log-prob with the tanh correction,
    by the explicit Gaussian formula of the JAX fused step."""
    log_std = clip_as_jax(log_std, LOG_STD_MIN, LOG_STD_MAX)
    std = torch.exp(log_std)
    u = mu + std * eps
    a = torch.tanh(u)
    logp = torch.sum(-0.5 * ((u - mu) / std) ** 2 - log_std
                     - 0.5 * math.log(2.0 * math.pi), dim=-1)
    logp = logp - torch.sum(torch.log(1.0 - a ** 2 + 1e-6), dim=-1)
    return a, logp


def _boost(cfg: TreeConfig, ens: Ensemble, X: torch.Tensor,
           grads: torch.Tensor, feat_w: torch.Tensor) -> Ensemble:
    """Append one tree fit on ``grads`` (numeric features, the full batch,
    candidates from this batch) at device index ``n_trees``."""
    tree = boost_tree(cfg, X, grads, feat_w)
    with profiling.span("write"):
        return write_tree(ens, tree, ens.n_trees)


def boost_tree(cfg: TreeConfig, X: torch.Tensor, grads: torch.Tensor,
               feat_w: torch.Tensor) -> dict:
    """The tree ``_boost`` appends, not yet written."""
    N = X.shape[0]
    w = torch.ones((N,), dtype=torch.float32, device=X.device)
    build = standardize_l2(grads, w) if cfg.score == "l2" else grads
    with profiling.span("candidates"):
        cand_vals = _masked_candidates(cfg, X, N)
        Xb = bucketize(X, cand_vals)
    return build_tree(cfg, Xb, cand_vals, grads, build, w, feat_w)


def _write_in_place(ens: Ensemble, tree: dict) -> None:
    """``write_tree(ens, tree, ens.n_trees)`` into ``ens``'s own tensors."""
    at = ens.n_trees.reshape(1).long()
    for f in _TREE_FIELDS:
        buf = getattr(ens, f)
        buf.index_copy_(0, at, tree[f][None].to(buf.dtype))
    ens.depths.index_copy_(0, at, tree["depth"].reshape(1).to(torch.int32))
    ens.n_trees.add_(1)


def _written(ens: Ensemble, work: Ensemble, K: int) -> Ensemble:
    """``ens`` with the K trees its working copy ``work`` grew past
    ``ens.n_trees``, written by ``write_tree``: every tree of a graph body
    reaches its learner through this module's write."""
    if K == 0:
        return ens
    idx = ens.n_trees + torch.arange(K, dtype=torch.int32,
                                     device=ens.n_trees.device)
    tree = {f: torch.index_select(getattr(work, f), 0, idx)
            for f in _TREE_FIELDS}
    tree["depth"] = torch.index_select(work.depths, 0, idx)
    return write_tree(ens, tree, idx)


def _critic_wb(hp: SACHyper, theta: torch.Tensor):
    return theta[:, :hp.act_dim], theta[:, hp.act_dim:]


def _clip_blocks(hp: SACHyper, g: torch.Tensor) -> torch.Tensor:
    if not hp.max_grad_norm:
        return g
    A = hp.act_dim
    return torch.cat([_block_clip(g[:, :A], hp.max_grad_norm),
                      _block_clip(g[:, A:], hp.max_grad_norm)], dim=1)


class _SACGraphs:
    """The static device buffers of one step's shapes and, on a CUDA
    device, the CUDA graph of its boosting body.  Each learner's ensemble
    (the actor's, then each critic's) has a working copy that the body
    reads through K5 and writes its tree into, in place, at the copy's
    device ``n_trees``.  ``handed`` holds the ensembles the last hand-off
    gave the learners: a copy is reloaded only when its learner's ensemble
    is another object (a new agent, a new bias, a capacity growth)."""

    def __init__(self, ensembles: Sequence[Ensemble], obs: torch.Tensor,
                 actions: torch.Tensor, feat_w: torch.Tensor):
        dev = obs.device
        self.obs = torch.empty_like(obs)
        self.actions = torch.empty_like(actions)
        self.eps_cur = torch.empty_like(actions)
        self.y = torch.empty((obs.shape[0],), dtype=torch.float32,
                             device=dev)
        self.alpha = torch.empty((), dtype=torch.float32, device=dev)
        self.feat_w = torch.empty_like(feat_w)
        self.stats = torch.zeros((len(STATS),), dtype=torch.float32,
                                 device=dev)
        self.work = [Ensemble(**{f: torch.empty_like(getattr(e, f))
                                 for f in FIELDS}) for e in ensembles]
        self.handed = [None] * len(self.work)
        self.graphs = {}

    def load(self, ensembles: Sequence[Ensemble]) -> None:
        """Reload the working copies of ensembles the last hand-off did not
        give (a host-side check: no read of the card)."""
        for i, (work, ens) in enumerate(zip(self.work, ensembles)):
            if ens is not self.handed[i]:
                for f in FIELDS:
                    getattr(work, f).copy_(getattr(ens, f))

    def stage(self, obs, actions, y, eps_cur, alpha, feat_w) -> None:
        for buf, src in ((self.obs, obs), (self.actions, actions),
                         (self.y, y), (self.eps_cur, eps_cur),
                         (self.alpha, alpha), (self.feat_w, feat_w)):
            buf.copy_(src)

    def body(self, acfg: TreeConfig, ccfg: TreeConfig, hp: SACHyper,
             specs) -> None:
        """Both critic boosting steps (gradients of 0.5 * (Q - y)^2 w.r.t.
        theta), then the actor boosting step against the UPDATED critics;
        the step's statistics into ``stats``."""
        actor_specs, critic_specs = specs
        A = hp.act_dim
        X = self.obs
        N = X.shape[0]
        actor, critics = self.work[0], self.work[1:]
        closses = []
        for ens in critics:
            theta = predict_sgd(ccfg, ens, X, critic_specs, 0, ens.capacity)
            p = theta.detach().requires_grad_(True)
            with torch.enable_grad():
                q = q_torch(*_critic_wb(hp, p), self.actions,
                            hp.q_func_type)
                loss = 0.5 * torch.mean((q - self.y) ** 2)
                (g,) = torch.autograd.grad(loss, p)
            g = _clip_blocks(hp, g * N)
            tree = boost_tree(ccfg, X, g, self.feat_w)
            with profiling.span("write"):
                _write_in_place(ens, tree)
            closses.append(loss.detach())

        theta_a = predict_sgd(acfg, actor, X, actor_specs, 0, actor.capacity)
        qthetas = [predict_sgd(ccfg, ens, X, critic_specs, 0, ens.capacity)
                   for ens in critics]
        p = theta_a.detach().requires_grad_(True)
        with torch.enable_grad():
            a, logp = sample_squashed(p[:, :A], p[:, A:], self.eps_cur)
            qs = [q_torch(*_critic_wb(hp, qt), a, hp.q_func_type)
                  for qt in qthetas]
            qmin = torch.amin(torch.stack(qs, 0), dim=0)
            aloss = torch.mean(self.alpha * logp - qmin)
            (ga,) = torch.autograd.grad(aloss, p)
        ga = _clip_blocks(hp, ga * N)
        tree = boost_tree(acfg, X, ga, self.feat_w)
        with profiling.span("write"):
            _write_in_place(actor, tree)
        self.stats.copy_(torch.stack([torch.mean(torch.stack(closses)),
                                      aloss.detach(),
                                      torch.mean(logp.detach())]))

    def hand_off(self, ensembles: Sequence[Ensemble]) -> list:
        """Each learner's ensemble with the tree its working copy grew,
        written by ``write_tree``; remembered for ``load``."""
        self.handed = [_written(ens, work, 1)
                       for ens, work in zip(ensembles, self.work)]
        return self.handed


def _sac_graphs(acfg: TreeConfig, ccfg: TreeConfig, hp: SACHyper, specs,
                ensembles: Sequence[Ensemble], obs: torch.Tensor,
                actions: torch.Tensor, feat_w: torch.Tensor) -> _SACGraphs:
    """The graph set of everything a capture bakes in, the ensembles'
    capacities among it (never a learner or an ensemble)."""
    key = ("sac", obs.device, acfg, ccfg, hp, specs, tuple(obs.shape),
           obs.dtype, tuple(actions.shape), len(ensembles) - 1,
           tuple(e.capacity for e in ensembles), tuple(feat_w.shape),
           feat_w.dtype, fit._DISABLE_FUSED_TREE)
    return graphs.cached_graphs(key, lambda: _SACGraphs(
        ensembles, obs, actions, feat_w))


def sac_train_step(acfg: TreeConfig, ccfg: TreeConfig, hp: SACHyper,
                   specs: Tuple[Tuple[OptimizerSpec, ...], ...],
                   actor_ens: Ensemble, critic_ens: Sequence[Ensemble],
                   prefixes: torch.Tensor, obs: torch.Tensor,
                   actions: torch.Tensor, rewards: torch.Tensor,
                   next_obs: torch.Tensor, dones: torch.Tensor,
                   discs: torch.Tensor, alpha: torch.Tensor,
                   feat_w: torch.Tensor, eps_next: torch.Tensor,
                   eps_cur: torch.Tensor):
    """One SAC gradient step on the tensors' device, with no host
    synchronisation.

    specs = (actor_specs, critic_specs); prefixes [n_critics] int32 target
    prefixes; alpha a 0-d tensor; eps_next / eps_cur [N, A] the standard
    normal draws for the next-observation and the current actions.  Every
    ensemble must have room for one more tree.  Returns (actor ensemble,
    tuple of critic ensembles, stats dict of 0-d device tensors).

    The target is the step's eager head, summed through this module's
    ``predict_sgd`` over the ensembles given; the boosting steps are one
    ``graphs.run_step`` of ``_SACGraphs.body``."""
    actor_specs, critic_specs = specs
    A = hp.act_dim

    # ---- target: y = R + disc * (1 - d) * (min_i Q_i^target - alpha lp')
    with profiling.span("target"):
        th_next = predict_sgd(acfg, actor_ens, next_obs, actor_specs, 0,
                              actor_ens.capacity)
        na, nlogp = sample_squashed(th_next[:, :A], th_next[:, A:], eps_next)
        tqs = []
        for i, ens in enumerate(critic_ens):
            th_t = predict_sgd(ccfg, ens, next_obs, critic_specs, 0,
                               prefixes[i])
            tqs.append(q_torch(*_critic_wb(hp, th_t), na, hp.q_func_type))
        qmin_t = torch.amin(torch.stack(tqs, 0), dim=0)
        y = (rewards + discs * (1.0 - dones)
             * (qmin_t - alpha * nlogp)).detach()

    ensembles = (actor_ens,) + tuple(critic_ens)
    g = _sac_graphs(acfg, ccfg, hp, specs, ensembles, obs, actions, feat_w)
    g.load(ensembles)
    g.stage(obs, actions, y, eps_cur, alpha, feat_w)
    graphs.run_step(g.graphs, "step", obs.device,
                    lambda: g.body(acfg, ccfg, hp, specs))
    with profiling.span("write"):
        new = g.hand_off(ensembles)
    # a copy: the next step overwrites the buffer
    stats = dict(zip(STATS, g.stats.clone()))
    return new[0], tuple(new[1:]), stats


def _to_device(a: np.ndarray, dev: torch.device) -> torch.Tensor:
    """A host array on ``dev`` without waiting for the card: staged in
    pinned memory and copied asynchronously (a plain copy from pageable
    memory synchronises the stream)."""
    t = torch.from_numpy(np.ascontiguousarray(a))
    if dev.type == "cuda":
        t = t.pin_memory()
    return t.to(dev, non_blocking=True)


def run_sac_train_step(algo, obs: np.ndarray, actions: np.ndarray,
                       rewards: np.ndarray, next_obs: np.ndarray,
                       dones: np.ndarray, discs: np.ndarray,
                       gen: torch.Generator) -> dict:
    """Host wrapper: grow capacities, copy the minibatch to the device in
    one packed block, draw the noise from ``gen`` (a generator on the
    learners' device), run the step, read the stats back (the one host
    synchronisation), then apply the ensemble-prefix target update and the
    temperature update.  Spans (utils/profiling.py): a ``minibatch``
    (learner "sac") holds ``update.stage`` (the counters, the packed copy
    and the noise), the step's ``target``, the body's ``candidates``,
    ``fit`` and ``write`` spans (on the card at a capture only), the
    hand-off's ``write`` and ``update.readback``; the body's
    ``graph.*`` counts fall in the ``minibatch`` itself.  rl/sac.py opens
    the train event's ``update`` around its steps."""
    actor_lr = algo.actor.learner
    critic_lrs = [c.learner for c in algo.critics]
    hp = SACHyper(act_dim=algo.act_dim, q_func_type=algo.q_func_type,
                  max_grad_norm=algo.max_grad_norm or 0.0)
    on_card = actor_lr.torch_device.type == "cuda"
    step = actor_lr._rl_host_n_trees
    with profiling.span("minibatch", u=step, learner="sac"):
        with profiling.span("update.stage"):
            # host-side tree counters: int(ens.n_trees) would wait for the
            # card
            for lr in [actor_lr] + critic_lrs:
                nt = lr._rl_host_n_trees
                if nt is None:
                    profiling.count_sync("sac_n_trees", on_card)
                    nt = int(lr.ens.n_trees)
                lr.ens = ensure_capacity(lr.ens, nt + 1)
                lr._rl_host_n_trees = nt + 1

            actor_lr._infer_mapping_from(obs)
            assert actor_lr.vocab is None, \
                "the fused SAC step takes numerical features only"
            N = len(obs)
            # one copy to the device: obs, actions, rewards, next_obs,
            # dones, discs, alpha, the target prefixes and the feature
            # weights
            parts = [np.asarray(x, np.float32).reshape(N, -1) for x in
                     (obs, actions, rewards, next_obs, dones, discs)]
            parts += [np.float32([[algo.alpha]]),
                      np.float32([[c.target_prefix for c in algo.critics]]),
                      actor_lr._host_feature_weights()[None, :]]
            pack = _to_device(np.concatenate([p.reshape(-1) for p in parts]),
                              actor_lr.torch_device)
            X, act, rew, X_next, done, disc, alpha, prefixes, fw = (
                t.reshape(p.shape) for t, p in
                zip(torch.split(pack, [p.size for p in parts]), parts))
            eps_next = torch.randn((N, algo.act_dim), generator=gen,
                                   device=X.device)
            eps_cur = torch.randn((N, algo.act_dim), generator=gen,
                                  device=X.device)
        new_actor, new_critics, stats = sac_train_step(
            actor_lr.cfg, critic_lrs[0].cfg, hp,
            (actor_lr.specs, critic_lrs[0].specs), actor_lr.ens,
            tuple(lr.ens for lr in critic_lrs), prefixes[0].to(torch.int32),
            X, act, rew[:, 0], X_next, done[:, 0], disc[:, 0], alpha[0, 0],
            fw[0], eps_next, eps_cur)

        actor_lr.ens = new_actor
        actor_lr.total_iterations += 1
        actor_lr._pred_cache = None
        for lr, ens, critic in zip(critic_lrs, new_critics, algo.critics):
            lr.ens = ens
            lr.total_iterations += 1
            lr._pred_cache = None
            if lr._rl_host_n_trees % critic.target_update_interval == 0:
                critic.target_prefix = lr._rl_host_n_trees

        with profiling.span("update.readback"):
            profiling.count_sync("sac_readback", on_card)
            vals = torch.stack([stats[k] for k in STATS]).cpu().numpy()
        out = {k: float(v) for k, v in zip(STATS, vals)}
        if algo.auto_alpha:
            algo.alpha_opt.zero_grad()
            alpha_loss = -(algo.log_alpha
                           * (out["logp_mean"] + algo.target_entropy))
            alpha_loss.backward()
            algo.alpha_opt.step()
    return out
