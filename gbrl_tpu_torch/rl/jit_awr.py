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
from ..ensemble import Ensemble, ensure_capacity
from ..ops.boosting import predict_sgd
from ..optimizers import OptimizerSpec
from ..utils import profiling
from .jit_sac import _boost, clip_as_jax


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
                    amb_idx: torch.Tensor, feat_w: torch.Tensor):
    """X [B, F] replay observations; acts [B, A]; rets [B] TD(lambda)
    critic targets; advs [B] TD(lambda) advantages (rl/awr.py
    ``_recompute_replay``); cmb_idx [Kc, mb] / amb_idx [Ka, mb] int64
    minibatch row plans on the device.  The ensembles must have room for
    Kc / Ka more trees.  Returns (actor_ens, critic_ens,
    (critic_loss_trace, actor_loss_trace)), the traces device tensors."""
    actor_specs, critic_specs = specs
    Kc, Ka = n_updates
    dev = X.device
    span = profiling.spanner()
    ctrace = []
    for k in range(Kc):
        with span("minibatch", u=k, learner="critic"):
            idx = cmb_idx[k]
            critic_ens, loss = awr_critic_step(ccfg, critic_specs,
                                               critic_ens, feat_w, X[idx],
                                               rets[idx])
        ctrace.append(loss)
    atrace = []
    for k in range(Ka):
        with span("minibatch", u=k, learner="actor"):
            idx = amb_idx[k]
            actor_ens, loss = awr_actor_step(acfg, hp, actor_specs,
                                             actor_ens, feat_w, X[idx],
                                             acts[idx], advs[idx])
        atrace.append(loss)
    return actor_ens, critic_ens, (_trace(ctrace, dev), _trace(atrace, dev))


def awr_critic_step(ccfg: TreeConfig, critic_specs, critic_ens: Ensemble,
                    feat_w: torch.Tensor, Xmb: torch.Tensor,
                    r: torch.Tensor):
    """One critic regression tree on a minibatch (rows already gathered).
    Returns (critic ensemble, the minibatch's loss)."""
    with profiling.span("grads"):
        v = predict_sgd(ccfg, critic_ens, Xmb, critic_specs, 0,
                        critic_ens.capacity)[:, 0]
        g = (v - r)[:, None]          # d/dv[0.5 * mse] * n
    critic_ens = _boost(ccfg, critic_ens, Xmb, g, feat_w)
    return critic_ens, 0.5 * torch.mean((v - r) ** 2)


def awr_actor_step(acfg: TreeConfig, hp: AWRHyper, actor_specs,
                   actor_ens: Ensemble, feat_w: torch.Tensor,
                   Xmb: torch.Tensor, a: torch.Tensor, adv: torch.Tensor):
    """One advantage-weighted actor tree on a minibatch (rows already
    gathered).  Returns (actor ensemble, the minibatch's loss)."""
    with profiling.span("grads"):
        g, loss = _actor_grads(acfg, hp, actor_specs, actor_ens, Xmb, a, adv)
    return _boost(acfg, actor_ens, Xmb, g, feat_w), loss.detach()


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


def run_awr_update(algo, r_obs: np.ndarray, r_act: np.ndarray,
                   r_ret: np.ndarray, rng, r_adv: np.ndarray) -> None:
    """Host wrapper: draw the minibatch plans from ``rng`` (critic first,
    then actor, as the JAX package), copy the replay to the device once,
    run the loop, update both learners in place.

    The JAX package pads the replay to a power of two to keep its jit
    signatures stable; nothing here is compiled per shape, and the plans
    never index past B, so the replay is copied as it is.  Spans
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
            plans[:len(cmb)], plans[len(cmb):], feat_w)
        actor_lr.total_iterations += Ka
        actor_lr._pred_cache = None
        critic_lr.total_iterations += Kc
        critic_lr._pred_cache = None
