"""The AWR update phase on the card: every critic regression step and every
advantage-weighted actor step of one iteration as one loop over device
tensors (counterpart of ``gbrl_tpu/rl/jit_awr.py``).

The replay is copied to the device once; then each step runs predict ->
loss gradients -> candidates (K1) -> one tree (the level path or K6), with
no host synchronisation inside the loop: the minibatch plans are device
index tensors, the tree index is the ensemble's device ``n_trees``, and the
loss traces stay on the device.  Where the JAX package has ``jax.jit`` and
``lax.fori_loop``, this is a Python loop that queues its launches and
returns.

``awr_update_loop`` runs the critic step body and the actor step body of
``_AWRGraphs`` once a tree through ``rl/graphs.py`` ``run_step``: the
bodies read static device buffers that the host refreshes once an update,
device counters replace the step numbers, and each step predicts over a
working copy of its learner's ensemble (K5, the trees of this update
included) and writes its tree into that copy in place; after the loop
``write_tree`` writes the trees each copy grew into its learner's
ensemble.  On a CUDA device each step replays its body's captured CUDA
graph; elsewhere the body is called.
The sharded loop of ``parallel/sharded_rl.py`` runs ``awr_critic_step``
and ``awr_actor_step`` instead.

Semantics mirror rl/awr.py ``learn``: critic minibatch regression on
bootstrapped returns (one tree per step), then actor advantage-weighted
regression with batch-standardized advantages (population std, as the
facade's ``np.std``) against the UPDATED critic.
"""
from __future__ import annotations

import math
from typing import NamedTuple, Tuple

import numpy as np
import torch

from ..config import TreeConfig
from ..ensemble import FIELDS, Ensemble, ensure_capacity
from ..ops import fit
from ..ops.boosting import predict_sgd
from ..optimizers import OptimizerSpec
from ..utils import profiling
from . import graphs
from .graphs import cached_graphs
from .jit_sac import (_boost, _write_in_place, _written, boost_tree,
                      clip_as_jax)


class AWRHyper(NamedTuple):
    act_dim: int
    beta: float
    max_weight: float
    learn_std: bool = True
    log_std_init: float = -0.5
    grad_clip: float = 10.0   # per-sample L2 clip of actor grads (0 = off)


def _trace(vals, dev: torch.device) -> torch.Tensor:
    """[max(K, 1)] per-step losses, zero where no step ran (as the JAX
    loop's preallocated trace)."""
    return (torch.stack(vals) if vals
            else torch.zeros((1,), dtype=torch.float32, device=dev))


def awr_update_loop(acfg: TreeConfig, ccfg: TreeConfig, hp: AWRHyper,
                    specs: Tuple[Tuple[OptimizerSpec, ...], ...],
                    n_updates: Tuple[int, int],
                    actor_ens: Ensemble, critic_ens: Ensemble,
                    X: torch.Tensor, acts: torch.Tensor, rets: torch.Tensor,
                    advs: torch.Tensor, cmb_idx: torch.Tensor,
                    amb_idx: torch.Tensor, feat_w: torch.Tensor,
                    rows: int = 0):
    """X [B, F] replay observations; acts [B, A]; rets [B] TD(lambda)
    critic targets; advs [B] TD(lambda) advantages (rl/awr.py
    ``_recompute_replay``); cmb_idx [Kc, mb] / amb_idx [Ka, mb] int64
    minibatch row plans on the device.  The ensembles must have room for
    Kc / Ka more trees.  Returns (actor_ens, critic_ens,
    (critic_loss_trace, actor_loss_trace)), the traces device tensors.

    Each step is one ``graphs.run_step`` of a body of ``_AWRGraphs``,
    whose static replay holds max(B, ``rows``) rows: a replay that grows
    up to ``rows`` keeps its graphs."""
    Kc, Ka = n_updates
    if Kc + Ka == 0:
        return actor_ens, critic_ens, (_trace([], X.device),
                                       _trace([], X.device))
    actor_specs, critic_specs = specs
    g = _awr_graphs(acfg, ccfg, hp, specs, n_updates, actor_ens, critic_ens,
                    X, acts, cmb_idx, amb_idx, feat_w, max(rows, X.shape[0]))
    g.load(actor_ens, critic_ens, X, acts, rets, advs, cmb_idx, amb_idx,
           feat_w)
    span = profiling.spanner()
    for learner, K, body in (
            ("critic", Kc, lambda: g.critic_body(ccfg, critic_specs)),
            ("actor", Ka, lambda: g.actor_body(acfg, hp, actor_specs))):
        for k in range(K):
            with span("minibatch", u=k, learner=learner):
                graphs.run_step(g.graphs, learner, X.device, body)
    # copies out of the buffers, which the next load overwrites
    return (_written(actor_ens, g.actor, Ka),
            _written(critic_ens, g.critic, Kc),
            (g.ctrace.clone(), g.atrace.clone()))


def awr_critic_step(ccfg: TreeConfig, critic_specs, critic_ens: Ensemble,
                    feat_w: torch.Tensor, Xmb: torch.Tensor,
                    r: torch.Tensor):
    """One critic regression tree on a minibatch (rows already gathered)
    of the sharded update phase (``parallel/sharded_rl.py``).  Returns
    (critic ensemble, the minibatch's loss)."""
    g, loss = _critic_grads(ccfg, critic_specs, critic_ens, Xmb, r)
    return _boost(ccfg, critic_ens, Xmb, g, feat_w), loss


def awr_actor_step(acfg: TreeConfig, hp: AWRHyper, actor_specs,
                   actor_ens: Ensemble, feat_w: torch.Tensor,
                   Xmb: torch.Tensor, a: torch.Tensor, adv: torch.Tensor):
    """One advantage-weighted actor tree on a minibatch (rows already
    gathered) of the sharded update phase (``parallel/sharded_rl.py``).
    Returns (actor ensemble, the minibatch's loss)."""
    with profiling.span("grads"):
        g, loss = _actor_grads(acfg, hp, actor_specs, actor_ens, Xmb, a, adv)
    return _boost(acfg, actor_ens, Xmb, g, feat_w), loss.detach()


def _critic_grads(ccfg: TreeConfig, critic_specs, critic_ens: Ensemble,
                  Xmb: torch.Tensor, r: torch.Tensor):
    """The critic's per-sample boosting gradients on a minibatch and its
    loss."""
    with profiling.span("grads"):
        v = predict_sgd(ccfg, critic_ens, Xmb, critic_specs, 0,
                        critic_ens.capacity)[:, 0]
        # d/dv[0.5 * mse] * n
        return (v - r)[:, None], 0.5 * torch.mean((v - r) ** 2)


def _actor_grads(acfg: TreeConfig, hp: AWRHyper, actor_specs,
                 actor_ens: Ensemble, Xmb: torch.Tensor, a: torch.Tensor,
                 adv: torch.Tensor):
    """The actor's per-sample boosting gradients on a minibatch and its
    loss."""
    A = hp.act_dim
    mb = Xmb.shape[0]
    # population std (ddof 0), as jnp.std and the facade's np.std
    adv = (adv - torch.mean(adv)) / (torch.std(adv, correction=0) + 1e-8)
    w = torch.exp(torch.clamp(adv / hp.beta, max=math.log(hp.max_weight)))
    theta = predict_sgd(acfg, actor_ens, Xmb, actor_specs, 0,
                        actor_ens.capacity)
    p = theta.detach().requires_grad_(True)
    with torch.enable_grad():
        # mu: sigma^2-free weighted regression (the official AWR
        # implementation's actor loss, arXiv:1910.00177 code):
        # 0.5 * w * ||a - mu||^2; dividing by sigma^2 makes the effective
        # boosting step lr * w / sigma^2 > 2 for high-weight leaves, an
        # oscillating divergence
        mu = p[:, :A]
        loss = torch.mean(w * 0.5 * torch.sum((a - mu) ** 2, dim=-1))
        if hp.learn_std:
            # sigma: weighted Gaussian MLE with mu stopped, log_std clipped
            # to [-2.5, 0.5] (zero gradient outside)
            log_std = clip_as_jax(p[:, A:], -2.5, 0.5)
            z = (a - mu.detach()) / torch.exp(log_std)
            loss = loss + torch.mean(
                w * torch.sum(log_std + 0.5 * z ** 2, dim=-1))
        (g,) = torch.autograd.grad(loss, p)
    g = g * mb
    if hp.grad_clip:
        # per-sample L2 clip (reference clip_grad_norm semantics,
        # gbrl/common/utils.py:270-295): bounds the leaf updates so a
        # region whose mu drifted cannot inject huge corrections into
        # neighbouring leaves
        norms = torch.sqrt(torch.sum(g * g, dim=-1, keepdim=True))
        g = g * torch.clamp(hp.grad_clip / (norms + 1e-8), max=1.0)
    return g, loss


class _AWRGraphs:
    """The static device buffers of one update's shapes and, on a CUDA
    device, the CUDA graphs of its two step bodies, the critic's and the
    actor's.  The replay sits in buffers of ``rows`` rows whose first B a
    load fills (the plans index below B), so a replay that grows keeps its
    graphs.  Each learner's
    ensemble has a working copy that its body reads through K5 and writes
    each new tree into, in place, at the copy's device ``n_trees``; the
    device counters ``uc`` / ``ua`` take the place of the step numbers and
    stage each step's loss."""

    def __init__(self, actor_ens: Ensemble, critic_ens: Ensemble, rows: int,
                 X: torch.Tensor, acts: torch.Tensor, cmb_idx: torch.Tensor,
                 amb_idx: torch.Tensor, feat_w: torch.Tensor,
                 n_updates: Tuple[int, int]):
        dev = X.device

        def zeros(shape, dtype=torch.float32):
            return torch.zeros(shape, dtype=dtype, device=dev)
        self.X = zeros((rows, X.shape[1]), X.dtype)
        self.acts = zeros((rows,) + tuple(acts.shape[1:]))
        self.rets, self.advs = zeros((rows,)), zeros((rows,))
        self.cplan = zeros(tuple(cmb_idx.shape), torch.int64)
        self.aplan = zeros(tuple(amb_idx.shape), torch.int64)
        self.feat_w = torch.empty_like(feat_w)
        self.actor, self.critic = (
            Ensemble(**{f: torch.empty_like(getattr(e, f)) for f in FIELDS})
            for e in (actor_ens, critic_ens))
        self.uc, self.ua = zeros((1,), torch.int64), zeros((1,), torch.int64)
        self.ctrace, self.atrace = (zeros((max(K, 1),)) for K in n_updates)
        self.graphs = {}

    def load(self, actor_ens: Ensemble, critic_ens: Ensemble,
             X: torch.Tensor, acts: torch.Tensor, rets: torch.Tensor,
             advs: torch.Tensor, cmb_idx: torch.Tensor, amb_idx: torch.Tensor,
             feat_w: torch.Tensor) -> None:
        """Refresh the static inputs (once an update): the replay's first B
        rows, the plans, both working copies, the counters and traces."""
        B = X.shape[0]
        for buf, src in ((self.X[:B], X), (self.acts[:B], acts),
                         (self.rets[:B], rets), (self.advs[:B], advs),
                         (self.cplan, cmb_idx), (self.aplan, amb_idx),
                         (self.feat_w, feat_w)):
            buf.copy_(src)
        for work, ens in ((self.actor, actor_ens), (self.critic, critic_ens)):
            for f in FIELDS:
                getattr(work, f).copy_(getattr(ens, f))
        for t in (self.uc, self.ua, self.ctrace, self.atrace):
            t.zero_()

    def critic_body(self, ccfg: TreeConfig, critic_specs) -> None:
        idx = torch.index_select(self.cplan, 0, self.uc)[0]
        Xmb = self.X[idx]
        g, loss = _critic_grads(ccfg, critic_specs, self.critic, Xmb,
                                self.rets[idx])
        tree = boost_tree(ccfg, Xmb, g, self.feat_w)
        with profiling.span("write"):
            _write_in_place(self.critic, tree)
            self.ctrace.index_copy_(0, self.uc, loss.reshape(1))
        self.uc.add_(1)

    def actor_body(self, acfg: TreeConfig, hp: AWRHyper, actor_specs) -> None:
        idx = torch.index_select(self.aplan, 0, self.ua)[0]
        Xmb = self.X[idx]
        with profiling.span("grads"):
            g, loss = _actor_grads(acfg, hp, actor_specs, self.actor, Xmb,
                                   self.acts[idx], self.advs[idx])
        tree = boost_tree(acfg, Xmb, g, self.feat_w)
        with profiling.span("write"):
            _write_in_place(self.actor, tree)
            self.atrace.index_copy_(0, self.ua, loss.detach().reshape(1))
        self.ua.add_(1)


def _awr_graphs(acfg: TreeConfig, ccfg: TreeConfig, hp: AWRHyper, specs,
                n_updates: Tuple[int, int], actor_ens: Ensemble,
                critic_ens: Ensemble, X: torch.Tensor, acts: torch.Tensor,
                cmb_idx: torch.Tensor, amb_idx: torch.Tensor,
                feat_w: torch.Tensor, rows: int) -> _AWRGraphs:
    """The graph set of everything a capture bakes in, the ensembles'
    capacities among it (never a learner or an ensemble)."""
    key = ("awr", X.device, acfg, ccfg, hp, specs, n_updates, rows,
           X.shape[1], X.dtype, tuple(acts.shape[1:]), tuple(cmb_idx.shape),
           tuple(amb_idx.shape), tuple(feat_w.shape), feat_w.dtype,
           actor_ens.capacity, critic_ens.capacity, fit._DISABLE_FUSED_TREE)
    return cached_graphs(key, lambda: _AWRGraphs(
        actor_ens, critic_ens, rows, X, acts, cmb_idx, amb_idx, feat_w,
        n_updates))


def run_awr_update(algo, r_obs: np.ndarray, r_act: np.ndarray,
                   r_ret: np.ndarray, rng, r_adv: np.ndarray) -> None:
    """Host wrapper: draw the minibatch plans from ``rng`` (critic first,
    then actor, as the JAX package), copy the replay to the device once,
    run the loop, update both learners in place.

    The JAX package pads the replay to a power of two to keep its jit
    signatures stable; here the plans never index past B, so the replay is
    copied as it is, and on the card the graphs hold it in buffers of
    ``buffer_size`` rows, so its growth captures nothing new.  Spans
    (utils/profiling.py): ``update`` holds ``update.stage`` (everything
    before the loop) and a ``minibatch`` a tree."""
    with profiling.span("update", algo="awr"):
        with profiling.span("update.stage"):
            actor_lr = algo.actor.learner
            critic_lr = algo.critic.learner
            B = len(r_obs)
            mb = min(algo.batch_size, B)
            Kc, Ka = algo.critic_updates, algo.actor_updates
            cmb = rng.integers(0, B, (max(Kc, 1), mb)).astype(np.int32)
            amb = rng.integers(0, B, (max(Ka, 1), mb)).astype(np.int32)

            Xn, Xc = actor_lr._prepare(r_obs, grow_vocab=False)
            assert Xc is None, \
                "the fused AWR update takes numerical features only"
            # host-side tree counters: reading ens.n_trees would wait for
            # the card
            nta = actor_lr._rl_host_n_trees
            if nta is None:
                nta = actor_lr.get_num_trees()
            ntc = critic_lr._rl_host_n_trees
            if ntc is None:
                ntc = critic_lr.get_num_trees()
            actor_lr.ens = ensure_capacity(actor_lr.ens, nta + Ka)
            critic_lr.ens = ensure_capacity(critic_lr.ens, ntc + Kc)
            actor_lr._rl_host_n_trees = nta + Ka
            critic_lr._rl_host_n_trees = ntc + Kc
            hp = AWRHyper(act_dim=algo.act_dim, beta=algo.beta,
                          max_weight=algo.max_weight,
                          learn_std=algo.learn_std,
                          log_std_init=algo.actor.log_std_init,
                          grad_clip=algo.max_actor_grad_norm)
            dev = actor_lr.torch_device
            on_card = dev.type == "cuda"
            A = algo.act_dim
            pack = torch.from_numpy(np.concatenate(
                [np.asarray(r_act, np.float32).reshape(B, A),
                 np.asarray(r_ret, np.float32).reshape(B, 1),
                 np.asarray(r_adv, np.float32).reshape(B, 1)], axis=1)
            ).to(dev)
            profiling.count_sync("awr_pack", on_card)
            plans = torch.from_numpy(np.concatenate([cmb, amb])
                                     .astype(np.int64)).to(dev)
            profiling.count_sync("awr_plan", on_card)
            feat_w = actor_lr._internal_feature_weights()
        actor_lr.ens, critic_lr.ens, _ = awr_update_loop(
            actor_lr.cfg, critic_lr.cfg, hp,
            (actor_lr.specs, critic_lr.specs), (Kc, Ka), actor_lr.ens,
            critic_lr.ens, Xn, pack[:, :A], pack[:, A], pack[:, A + 1],
            plans[:len(cmb)], plans[len(cmb):], feat_w,
            rows=algo.buffer_size)
        actor_lr.total_iterations += Ka
        actor_lr._pred_cache = None
        critic_lr.total_iterations += Kc
        critic_lr._pred_cache = None
