"""Boosting entry points: the RL single-tree step and the supervised fit loop
(counterpart of ``gbrl_tpu/ops/boosting.py``; reference Fitter::step_cpu,
fitter.cpp:50-115, and Fitter::fit_cpu, fitter.cpp:117-261).

Both run on the tensors' device without waiting for it: tree indices and
the ensemble's ``n_trees`` stay device tensors, so one ``boost_step``
queues its work and returns.  ``fit_loop`` is a Python loop over the
iterations that keeps the full-dataset predictions up to date one new tree
at a time, as the JAX package's ``lax.fori_loop`` does.
"""
from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch

from ..config import TreeConfig
from ..ensemble import Ensemble
from ..optimizers import OptimizerSpec, scheduler_lr, sgd_coeff
from ..utils import profiling
from .candidates import (bucketize, categorical_candidate_mask,
                         numerical_candidates, quantile_index)
from .fit import build_tree, standardize_l2
from .loss import multirmse_grads, multirmse_loss
from .predict import cv_momentum, single_tree_leaf_values, weighted_leaf_sum

_TREE_FIELDS = ("feat", "thr", "cat_code", "is_split", "is_numeric",
                "leaf_values", "counts")


def write_tree(ens: Ensemble, tree: dict, idx: torch.Tensor) -> Ensemble:
    """Insert fitted trees at device indices: one tree at ``idx`` an int32
    scalar tensor, or U trees at ``idx`` [U] distinct int32 indices, each
    field of ``tree`` then stacked [U, ...] (``depth`` [U]).  One
    ``index_copy`` a field: a new Ensemble, the old one unchanged (copies
    share it)."""
    one = idx.dim() == 0
    at = idx.reshape(-1).long()
    kw = {f: torch.index_copy(getattr(ens, f), 0, at,
                              (tree[f][None] if one else tree[f])
                              .to(getattr(ens, f).dtype))
          for f in _TREE_FIELDS}
    kw["depths"] = torch.index_copy(ens.depths, 0, at,
                                    tree["depth"].reshape(at.shape)
                                    .to(torch.int32))
    top = idx if one else torch.amax(idx)
    kw["n_trees"] = torch.maximum(ens.n_trees, top.to(torch.int32) + 1)
    return ens.replace(**kw)


def _cv_adjust(grads: torch.Tensor, mom: torch.Tensor,
               w: torch.Tensor, mesh=None) -> torch.Tensor:
    """alpha-weighted momentum subtraction (fitter.cpp:610-625) given the
    bias-corrected momentum of the batch; alpha = cov / var clipped to
    [-1, 1], 0 for zero-variance momentum.  With a ``mesh`` the rows are
    this rank's and the moments are the global ones (two sums over the
    ranks: the means, then var and cov)."""
    O = grads.shape[1]
    s = torch.cat([torch.sum(w).reshape(1),
                   torch.sum(grads * w[:, None], dim=0),
                   torch.sum(mom * w[:, None], dim=0)])
    if mesh is not None:
        s = mesh.sum_ranks(s)
    n = torch.clamp(s[0], min=1.0)
    g_mean = s[1:1 + O] / n
    m_mean = s[1 + O:] / n
    gc = (grads - g_mean[None, :]) * w[:, None]
    mc = (mom - m_mean[None, :]) * w[:, None]
    denom = torch.clamp(n - 1.0, min=1.0)
    vc = torch.cat([torch.sum(mc * mc, dim=0), torch.sum(gc * mc, dim=0)])
    if mesh is not None:
        vc = mesh.sum_ranks(vc)
    var = vc[:O] / denom
    cov = vc[O:] / denom
    alpha = torch.where(var > 0, cov / torch.where(var > 0, var,
                                                   torch.ones_like(var)),
                        torch.zeros_like(var))
    alpha = torch.clamp(alpha, -1.0, 1.0)
    return grads - alpha[None, :] * mc


def apply_control_variates(cfg: TreeConfig, ens: Ensemble, Xn: torch.Tensor,
                           grads: torch.Tensor, sample_w: torch.Tensor,
                           Xc: Optional[torch.Tensor] = None,
                           mesh=None) -> torch.Tensor:
    """Gradient variance reduction (fitter.cpp:585-633), applied only when
    the ensemble already has trees (fitter.cpp:53-55).  The momentum is
    per row (K4 / K5 on this rank's rows); its moments are global.  A
    ``cv`` span (utils/profiling.py) with the rows and the tree slots the
    momentum walks."""
    with profiling.span("cv", rows=grads.shape[0], trees=ens.capacity):
        mom = cv_momentum(cfg, ens, Xn, Xc)                   # bias-corrected
        adjusted = _cv_adjust(grads, mom, sample_w, mesh)
        return torch.where(ens.n_trees > 0, adjusted, grads)


def boost_step(cfg: TreeConfig, ens: Ensemble, Xn: torch.Tensor,
               grads: torch.Tensor, feat_w: torch.Tensor,
               Xc: Optional[torch.Tensor] = None,
               feat_w_cat: Optional[torch.Tensor] = None,
               n_codes: int = 0, mesh=None) -> Ensemble:
    """One RL boosting iteration == Fitter::step_cpu: optional control
    variates -> L2 standardization -> candidates from this batch (K1
    buckets; categorical top-k by gradient norm) -> one tree -> append at
    index ``n_trees``.  The ensemble must have room for one more tree.
    With a ``mesh`` (parallel/sharded.py) the rows are this rank's and
    every cross-sample quantity is summed over the ranks, so every rank
    appends the same tree."""
    has_num = Xn.shape[1] > 0
    has_cat = Xc is not None
    N = Xn.shape[0] if has_num else Xc.shape[0]
    sample_w = torch.ones((N,), dtype=torch.float32, device=grads.device)
    if cfg.use_control_variates:
        grads = apply_control_variates(cfg, ens, Xn, grads, sample_w, Xc,
                                       mesh)
    build = (standardize_l2(grads, sample_w, mesh) if cfg.score == "l2"
             else grads)
    cand_vals = Xb = cat_valid = None
    if has_num:
        cand_vals = numerical_candidates(cfg, Xn, mesh)
        Xb = bucketize(Xn, cand_vals)
    if has_cat:
        # per-sample squared gradient norms select categorical candidates
        # (fitter.cpp:67-70, after the control variates)
        cat_valid = categorical_candidate_mask(
            Xc, torch.sum(grads * grads, dim=-1), cfg.n_bins, n_codes,
            mesh=mesh)
    tree = build_tree(cfg, Xb, cand_vals, grads, build, sample_w, feat_w,
                      Xc, cat_valid, feat_w_cat, mesh)
    return write_tree(ens, tree, ens.n_trees)


def predict_sgd(cfg: TreeConfig, ens: Ensemble, Xn: torch.Tensor,
                specs: Sequence[OptimizerSpec], start_tree,
                stop_tree, Xc: Optional[torch.Tensor] = None) -> torch.Tensor:
    """bias + sum of per-tree SGD updates over [start_tree, stop_tree)
    (ints or device tensors)."""
    coeff = sgd_coeff(specs, ens.capacity, cfg.output_dim, ens.n_trees,
                      start_tree, stop_tree)
    return ens.bias[None, :] + weighted_leaf_sum(cfg, ens, Xn, coeff, Xc)


def _lr_columns(specs: Sequence[OptimizerSpec], O: int,
                t: torch.Tensor) -> torch.Tensor:
    """-lr per output column at tree index t (SGD only: fit rejects Adam,
    gbrl.cpp:1006-1012)."""
    j = torch.arange(O, device=t.device)
    coeff = torch.zeros((O,), dtype=torch.float32, device=t.device)
    for spec in specs:
        mask = ((j >= spec.start_idx) & (j < spec.stop_idx)).to(torch.float32)
        coeff = coeff - scheduler_lr(spec, t) * mask
    return coeff


def tree_prediction(cfg: TreeConfig, specs: Sequence[OptimizerSpec],
                    tree: dict, t_idx: torch.Tensor, X: torch.Tensor,
                    Xc: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The SGD contribution of one tree, at tree index ``t_idx``, to the
    predictions of the rows X (and their codes Xc); leaf values are
    immutable once fit."""
    v_new = single_tree_leaf_values(cfg, tree, X, Xc)
    return _lr_columns(specs, cfg.output_dim, t_idx)[None, :] * v_new


def fit_loop(cfg: TreeConfig, iterations: int, ens: Ensemble,
             Xn_pad: torch.Tensor, targets_pad: torch.Tensor, n_samples: int,
             specs: Tuple[OptimizerSpec, ...], feat_w: torch.Tensor,
             Xc_pad: Optional[torch.Tensor] = None,
             feat_w_cat: Optional[torch.Tensor] = None,
             n_codes: int = 0) -> Tuple[Ensemble, torch.Tensor, torch.Tensor]:
    """Supervised multi-iteration fit == Fitter::fit_cpu.

    Data arrives shuffled and padded to a multiple of the batch size; padded
    rows are masked out.  Candidates come once from the full dataset
    (fitter.cpp:134-151); the bias is already mean(targets).  Per iteration:
    the next mini-batch, MultiRMSE grads from the cached predictions,
    control variates (after the first iteration), L2 standardization, one
    tree appended.  The full-dataset predictions (and the control-variate
    momentum) are updated with the new tree only, so the loop is
    O(iterations * N * depth).  The ensemble must have room for
    ``iterations`` more trees.  Returns (ensemble, full-dataset loss,
    per-iteration batch losses), losses as device tensors."""
    dev = targets_pad.device
    N_pad = Xn_pad.shape[0]
    bs = min(cfg.batch_size, N_pad)
    n_batches = max(1, -(-n_samples // bs))
    has_num = Xn_pad.shape[1] > 0
    has_cat = Xc_pad is not None
    O = cfg.output_dim

    full_w = (torch.arange(N_pad, device=dev) < n_samples).to(torch.float32)
    cand_vals = Xb_pad = None
    if has_num:
        cand_vals = _masked_candidates(cfg, Xn_pad, n_samples)
        Xb_pad = bucketize(Xn_pad, cand_vals)

    n_trees0 = ens.n_trees
    beta = torch.full((), cfg.cv_beta, dtype=torch.float32, device=dev)
    preds_full = predict_sgd(cfg, ens, Xn_pad, specs, 0, n_trees0, Xc_pad)
    cat_valid = None
    if has_cat:
        # categorical candidates selected once from the initial residual
        # gradient norms (fitter.cpp:152-163)
        g0 = (preds_full - targets_pad) * full_w[:, None]
        cat_valid = categorical_candidate_mask(
            Xc_pad, torch.sum(g0 * g0, dim=-1), cfg.n_bins, n_codes, full_w)
    if cfg.use_control_variates:
        corr0 = torch.sqrt(1.0 - torch.pow(beta, n_trees0.to(torch.float32)))
        mom_full = cv_momentum(cfg, ens, Xn_pad, Xc_pad) * torch.where(
            n_trees0 > 0, corr0, torch.ones_like(corr0))
    else:
        mom_full = None

    losses = []
    for i in range(iterations):
        start = (i % n_batches) * bs
        sl = slice(start, start + bs)
        Xb = Xb_pad[sl] if has_num else None
        Xc = Xc_pad[sl] if has_cat else None
        batch_n = min(bs, n_samples - start)
        w = (torch.arange(bs, device=dev) < batch_n).to(torch.float32)
        grads, batch_loss = multirmse_grads(preds_full[sl], targets_pad[sl], w)
        losses.append(batch_loss)
        t = n_trees0 + i
        if cfg.use_control_variates and i > 0:
            corr = 1.0 / torch.sqrt(1.0 - torch.pow(beta, t.to(torch.float32)))
            adjusted = _cv_adjust(grads, mom_full[sl] * corr, w)
            grads = torch.where(t > 0, adjusted, grads)
        build = standardize_l2(grads, w) if cfg.score == "l2" else grads
        tree = build_tree(cfg, Xb, cand_vals, grads, build, w, feat_w,
                          Xc, cat_valid, feat_w_cat)
        ens = write_tree(ens, tree, t)
        # incremental update: evaluate only the new tree on the full dataset
        v_new = single_tree_leaf_values(cfg, tree, Xn_pad, Xc_pad)
        preds_full = preds_full + _lr_columns(specs, O, t)[None, :] * v_new
        if cfg.use_control_variates:
            mom_full = beta * mom_full + (1.0 - beta) * v_new
    loss = multirmse_loss(preds_full, targets_pad, full_w)
    per_iter = (torch.stack(losses) if losses else
                torch.zeros((0,), dtype=torch.float32, device=dev))
    return ens, loss, per_iter


def _masked_candidates(cfg: TreeConfig, Xn_pad: torch.Tensor,
                       n_samples: int) -> torch.Tensor:
    """Candidates over the first ``n_samples`` rows of a padded array:
    padded rows sort past every real value (quantile) and drop out of
    min/max (uniform)."""
    N_pad = Xn_pad.shape[0]
    dev = Xn_pad.device
    mask = (torch.arange(N_pad, device=dev) < n_samples)[:, None]
    pos_inf = torch.full((), float("inf"), device=dev)
    neg_inf = torch.full((), float("-inf"), device=dev)
    mx = torch.amax(torch.where(mask, Xn_pad, neg_inf), dim=0)
    if cfg.generator == "uniform":
        mn = torch.amin(torch.where(mask, Xn_pad, pos_inf), dim=0)
        step = (mx - mn) / float(cfg.n_bins)
        bins = torch.arange(cfg.n_bins, dtype=torch.float32, device=dev)
        return mn[:, None] + bins[None, :] * step[:, None]
    # quantile (split_candidate_generator.cpp:216-249) with real-row counts
    idx = quantile_index(n_samples, cfg.n_bins, N_pad, dev)
    Xs = torch.sort(torch.where(mask, Xn_pad, pos_inf), dim=0,
                    stable=True).values
    cands = Xs[idx, :].T
    # a grid must stay finite and ascending even if n_bins >= rows
    return torch.where(torch.isfinite(cands), cands, mx[:, None]).contiguous()
