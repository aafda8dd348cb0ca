"""The A2C update on the card: the loss gradients and one boosting step on
device tensors, returning the new tree for the host mirror (counterpart of
``gbrl_tpu/rl/jit_a2c.py``).

The rollout is copied to the device once; the step computes the A2C loss
gradients, runs ``boost_step``'s semantics (control variates -> candidates
from the full batch (K1) -> one tree -> append; ops/boosting.py), and hands
the fitted tree to the host mirror from the same device-to-host copy as the
loss statistics.

Semantics match the torch facade path (rl/a2c.py): weighted advantage
normalization over the valid mask (torch's unbiased std), policy loss +
ent_coef * entropy loss + vf_coef * 0.5 * value MSE, gradients scaled by
the FULL row count n (the facade's harvest convention, models/
actor_critic.py; autoreset rows get zero gradient but stay in the fit
batch, as in the facade).  Reference: gbrl.cpp:939-981 (step dispatch),
fitter.cpp:50-115 (step_cpu), fitter.cpp:585-633 (control variates).
"""
from __future__ import annotations

from typing import Dict, NamedTuple, Tuple

import numpy as np
import torch

from ..config import TreeConfig
from ..ensemble import Ensemble, ensure_capacity
from ..ops.boosting import apply_control_variates, predict_sgd, write_tree
from ..ops.candidates import bucketize, numerical_candidates
from ..ops.fit import build_tree, standardize_l2
from ..optimizers import OptimizerSpec, adam_delta
from ..utils import profiling
from .jit_update import normalized_advantage

# the tree fields the mirror reads, in the order they are packed
MIRROR_FIELDS = ("feat", "thr", "is_split", "is_numeric", "cat_code",
                 "leaf_values")
STATS = ("policy_loss", "value_loss", "entropy")


class A2CHyper(NamedTuple):
    """A2C hyperparameters."""
    n_actions: int
    ent_coef: float
    vf_coef: float
    normalize_advantage: bool


def a2c_update(cfg: TreeConfig, hp: A2CHyper, ens: Ensemble, X: torch.Tensor,
               actions: torch.Tensor, adv: torch.Tensor, ret: torch.Tensor,
               valid: torch.Tensor, specs: Tuple[OptimizerSpec, ...],
               feat_w: torch.Tensor):
    """One A2C boosting step on the tensors' device, with no host
    synchronisation.  The ensemble must have room for one more tree.
    Returns (ensemble, tree, stats), the stats device scalars."""
    na = hp.n_actions
    N = X.shape[0]
    preds = predict_sgd(cfg, ens, X, specs, 0, ens.capacity)
    for spec in specs:
        if spec.algo == "Adam":
            preds = preds - adam_delta(cfg, ens, X, spec, 0, ens.capacity)
    w = valid
    nw = torch.clamp(torch.sum(w), min=1.0)
    adv_n = normalized_advantage(adv, w, nw) if hp.normalize_advantage \
        else adv
    p = preds.detach().requires_grad_(True)
    with torch.enable_grad():
        logp_all = torch.log_softmax(p[:, :na], dim=-1)
        lp = torch.gather(logp_all, 1, actions.long()[:, None])[:, 0]
        policy_loss = -torch.sum(w * adv_n * lp) / nw
        ent = -torch.sum(torch.exp(logp_all) * logp_all, dim=-1)
        entropy_loss = -torch.sum(w * ent) / nw
        value_loss = hp.vf_coef * 0.5 * torch.sum(
            w * (ret - p[:, na]) ** 2) / nw
        total = policy_loss + hp.ent_coef * entropy_loss + value_loss
        (g,) = torch.autograd.grad(total, p)
    grads = g * N                      # facade harvest: mean-loss grad * n
    # boost_step's semantics (ops/boosting.py), numeric features only
    sample_w = torch.ones((N,), dtype=torch.float32, device=X.device)
    if cfg.use_control_variates:
        grads = apply_control_variates(cfg, ens, X, grads, sample_w)
    build = standardize_l2(grads, sample_w) if cfg.score == "l2" else grads
    cand_vals = numerical_candidates(cfg, X)
    tree = build_tree(cfg, bucketize(X, cand_vals), cand_vals, grads, build,
                      sample_w, feat_w)
    new_ens = write_tree(ens, tree, ens.n_trees)
    stats = dict(policy_loss=policy_loss.detach(),
                 value_loss=value_loss.detach(),
                 entropy=(torch.sum(w * ent) / nw).detach())
    return new_ens, tree, stats


def fetch_tree_and_stats(tree: dict, stats: Dict[str, torch.Tensor],
                         with_tree: bool):
    """One device-to-host copy of the loss statistics and, when asked, the
    tree's mirror fields: all packed as float32 (the integer fields are
    small, so exact) and split again on the host.  Returns (tree dict of
    numpy arrays or None, stats dict of floats)."""
    parts = [torch.stack([stats[k].to(torch.float32) for k in STATS])]
    if with_tree:
        parts += [tree[k].to(torch.float32).reshape(-1) for k in MIRROR_FIELDS]
    flat = torch.cat(parts).cpu().numpy()
    out = {k: float(v) for k, v in zip(STATS, flat[:len(STATS)])}
    if not with_tree:
        return None, out
    host, at = {}, len(STATS)
    for k in MIRROR_FIELDS:
        t = tree[k]
        n = t.numel()
        a = flat[at:at + n].reshape(tuple(t.shape))
        host[k] = a.astype({torch.int32: np.int32, torch.bool: np.bool_}
                           .get(t.dtype, np.float32))
        at += n
    return host, out


def run_a2c_update(learner, obs: np.ndarray, actions: np.ndarray,
                   adv: np.ndarray, ret: np.ndarray, valid: np.ndarray,
                   hp: A2CHyper, mirror=None) -> dict:
    """Host wrapper: copy the rollout to the device (observations and one
    packed [N, 4] float block), run the step, and append the returned tree
    to the host mirror from the same copy back as the stats.  Updates the
    learner in place; returns the stats dict.  Spans (utils/profiling.py):
    ``update`` holds ``update.stage`` (the copies in), the step (its
    ``adam`` and ``cv`` spans) and ``update.readback``; the host waits are
    counted as ``sync.prepare``, ``sync.feature_weights``,
    ``sync.a2c_pack`` and ``sync.a2c_readback`` (``sync.a2c_n_trees``
    where the host counter of trees is unset)."""
    with profiling.span("update", algo="a2c"):
        with profiling.span("update.stage"):
            Xn, Xc = learner._prepare(obs, grow_vocab=False)
            assert Xc is None, \
                "the fused A2C update takes numerical features only"
            on_card = learner.torch_device.type == "cuda"
            # the host copy of n_trees: reading ens.n_trees would wait for
            # the card
            nt = learner._rl_host_n_trees
            if nt is None:
                profiling.count_sync("a2c_n_trees", on_card)
                nt = int(learner.ens.n_trees)
            learner.ens = ensure_capacity(learner.ens, nt + 1)
            learner._rl_host_n_trees = nt + 1
            n = len(obs)
            pack = torch.from_numpy(np.stack(
                [np.asarray(a, np.float32).reshape(n)
                 for a in (actions, adv, ret, valid)], axis=1)).to(
                learner.torch_device)
            profiling.count_sync("a2c_pack", on_card)
            feat_w = learner._internal_feature_weights()
        new_ens, tree, stats = a2c_update(
            learner.cfg, hp, learner.ens, Xn, pack[:, 0].to(torch.int64),
            pack[:, 1], pack[:, 2], pack[:, 3], learner.specs, feat_w)
        learner.ens = new_ens
        learner.total_iterations += 1
        learner._pred_cache = None
        with profiling.span("update.readback"):
            profiling.count_sync("a2c_readback", on_card)
            host_tree, stats = fetch_tree_and_stats(tree, stats,
                                                    mirror is not None)
            if mirror is not None:
                mirror.append_tree(host_tree)
        return stats
