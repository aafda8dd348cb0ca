"""Data-parallel RL update phases over ``torch.distributed`` (counterpart of
``gbrl_tpu/parallel/sharded_rl.py``).

Each rank keeps its own shard of the rollout (PPO) or the replay (AWR); the
ensembles are replicated.  PPO's full-rollout predictions are sharded too:
each rank predicts its own rows once (K4 / K5) and adds each new tree's
leaf values on its own rows only.  The minibatch plans hold global row
indices and are the same on every rank (drawn from a shared seed).  For each
minibatch the rows it names are gathered from their owners with one
collective: every rank packs the plan's rows it owns (observations,
predictions, actions, log-probs, advantages, returns, the valid mask) into
one tensor, ``Mesh.gather_ranks`` stacks every rank's, and each row is
taken from its owner's slot, a selection, never a sum, so the values are
exact (``-0.0`` included).  The minibatch's tree is then fitted the same on
every rank, as one process fits it (the JAX package lets XLA gather the
minibatch rows likewise): a minibatch is 256-2048 rows, and the quantile
grid needs all of them anyway.  So both tree paths run here, K6 included.

The per-minibatch steps are ``rl/jit_update.py`` ``ppo_minibatch_step``
and ``rl/jit_awr.py`` ``awr_critic_step`` / ``awr_actor_step``: the
kernels of the single-process loops' step bodies, run as plain calls (a
CUDA graph cannot hold the gathers), each tree written out of place.  On
NCCL the loops queue their work without a host synchronisation; on gloo
every gather waits for the host.
"""
from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch

from ..config import TreeConfig
from ..ensemble import Ensemble
from ..ops.boosting import predict_sgd, tree_prediction
from ..optimizers import OptimizerSpec
from ..rl.jit_awr import AWRHyper, _trace, awr_actor_step, awr_critic_step
from ..rl.jit_update import PPOHyper, entropy_trace, ppo_minibatch_step
from .sharded import Mesh


def _gather_rows(mesh: Mesh, tables: Sequence[torch.Tensor],
                 idx: torch.Tensor) -> torch.Tensor:
    """Rows ``idx`` (global, into the row-sharded ``[B, C_i]`` tables laid
    side by side) on every rank, each from its owner: ``[len(idx),
    sum C_i]``."""
    per_rank = tables[0].shape[0]
    owner = torch.div(idx, per_rank, rounding_mode="floor")
    local = torch.where(owner == mesh.rank, idx - mesh.rank * per_rank,
                        torch.zeros_like(idx))
    parts = mesh.gather_ranks(torch.cat([t[local] for t in tables], dim=1))
    return parts[owner, torch.arange(idx.shape[0], device=idx.device)]


def _columns(g: torch.Tensor, widths: Sequence[int]):
    """``g`` split into contiguous column blocks (the layout the
    single-process loops index out of)."""
    return [b.contiguous() for b in torch.split(g, list(widths), dim=1)]


def sharded_ppo_update(cfg: TreeConfig, hp: PPOHyper, mesh: Mesh,
                       ens: Ensemble, X: torch.Tensor, mb_idx, mb_n,
                       actions: torch.Tensor, old_logp: torch.Tensor,
                       adv: torch.Tensor, ret: torch.Tensor,
                       specs: Tuple[OptimizerSpec, ...],
                       feat_w: torch.Tensor,
                       valid: Optional[torch.Tensor] = None,
                       n_trees0: Optional[int] = None):
    """One PPO update phase (all epochs x minibatches) with the rollout
    sharded over the mesh: X [B_local, F], actions / old_logp / adv / ret /
    valid [B_local] this rank's rows (global rows rank * B_local onward);
    mb_idx [U, mb] global row indices (a device or host array), mb_n [U]
    host ints, both the same on every rank; ``n_trees0`` the ensemble's tree
    count as a host int (read from the device when None).  The ensemble
    must have room for U more trees.  Returns (ensemble, entropy trace),
    the same on every rank.  A configuration with categorical features
    raises: the rollout gathered here is numeric only."""
    if cfg.n_cat_features > 0:
        raise ValueError(
            f"sharded_ppo_update takes numeric features only; this "
            f"configuration has {cfg.n_cat_features} categorical features: "
            "train it in one process (rl/jit_update.py run_ppo_update takes "
            "the rollout's codes)")
    dev = X.device
    mb_idx = torch.as_tensor(mb_idx).to(dev, torch.int64)
    mb_n = [int(n) for n in mb_n]
    if n_trees0 is None:
        n_trees0 = int(ens.n_trees)
    cols = [actions.to(torch.float32), old_logp, adv, ret]
    if valid is not None:
        cols.append(valid.to(torch.float32))
    rollout = torch.cat([X, torch.stack(cols, dim=1)], dim=1)
    widths = (X.shape[1], len(cols), cfg.output_dim)
    preds_full = predict_sgd(cfg, ens, X, specs, 0, n_trees0)
    rows = torch.arange(mb_idx.shape[1], device=dev)
    ents = []
    for u in range(len(mb_n)):
        Xmb, c, pmb = _columns(
            _gather_rows(mesh, (rollout, preds_full), mb_idx[u]), widths)
        w = (rows < mb_n[u]).to(torch.float32)
        if valid is not None:
            w = w * c[:, 4]             # autoreset rows (rl/buffers.py flat)
        ens, tree, t_idx, ent = ppo_minibatch_step(
            cfg, hp, specs, feat_w, ens, n_trees0 + u, mb_n[u], w, Xmb, pmb,
            c[:, 0].to(torch.int64), c[:, 1].contiguous(),
            c[:, 2].contiguous(), c[:, 3].contiguous())
        ents.append(ent)
        preds_full = preds_full + tree_prediction(cfg, specs, tree, t_idx, X)
    return ens, entropy_trace(ents, dev)


def sharded_awr_update(acfg: TreeConfig, ccfg: TreeConfig, hp: AWRHyper,
                       mesh: Mesh, actor_ens: Ensemble, critic_ens: Ensemble,
                       X: torch.Tensor, acts: torch.Tensor,
                       rets: torch.Tensor, advs: torch.Tensor, cmb_idx,
                       amb_idx,
                       specs: Tuple[Tuple[OptimizerSpec, ...], ...],
                       feat_w: torch.Tensor):
    """One AWR update phase (every critic, then every actor boosting step)
    with the replay sharded over the mesh: X [B_local, F], acts
    [B_local, A], rets / advs [B_local] this rank's rows; cmb_idx [Kc, mb] /
    amb_idx [Ka, mb] global row plans, the same on every rank.  The
    ensembles must have room for Kc / Ka more trees.  Returns (actor_ens,
    critic_ens, (critic_trace, actor_trace)), the same on every rank."""
    actor_specs, critic_specs = specs
    dev = X.device
    A = hp.act_dim
    replay = torch.cat([X, acts.reshape(X.shape[0], A), rets[:, None],
                        advs[:, None]], dim=1)
    widths = (X.shape[1], A, 1, 1)
    ctrace = []
    for idx in torch.as_tensor(cmb_idx).to(dev, torch.int64):
        Xmb, _, r, _ = _columns(_gather_rows(mesh, (replay,), idx), widths)
        critic_ens, loss = awr_critic_step(ccfg, critic_specs, critic_ens,
                                           feat_w, Xmb, r[:, 0])
        ctrace.append(loss)
    atrace = []
    for idx in torch.as_tensor(amb_idx).to(dev, torch.int64):
        Xmb, a, _, adv = _columns(_gather_rows(mesh, (replay,), idx), widths)
        actor_ens, loss = awr_actor_step(acfg, hp, actor_specs, actor_ens,
                                         feat_w, Xmb, a, adv[:, 0])
        atrace.append(loss)
    return actor_ens, critic_ens, (_trace(ctrace, dev), _trace(atrace, dev))
