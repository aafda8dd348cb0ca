"""Ensemble inference: heap walk + coefficient-weighted leaf sum.

Counterpart of ``gbrl_tpu/ops/predict.py``.  The JAX package fetches every
node through a one-hot select because general gathers lower to scalar loops
on a TPU; on a GPU a direct gather is the natural walk, so
``chunk_leaf_rel`` indexes the heap directly.

``weighted_leaf_sum`` dispatches as ``gbrl_tpu/ops/predict.py:138-152``
does: with no categorical columns it runs K4 (greedy) or K5 (oblivious)
from ``ops/kernels.py`` — the kernel on a CUDA tensor, its plain version on
a CPU tensor — with the leaf values and the coefficients, which the kernel
multiplies as it stages the trees.  The JAX package's feature/depth guard
there is the TPU's VMEM budget and has no counterpart here: past its
shared-memory budget the kernel reads the trees from global memory.  With
categorical columns the plain torch walk below runs on whatever device the
tensors are on, as the JAX package runs XLA there.

With coeff[t, j] = -lr_opt(t) on each optimizer's column range the weighted
reduction reproduces the reference's SGD semantics; with EMA weights it is
the control-variate momentum (reference predictor.cpp:37-119).
"""
from __future__ import annotations

from typing import Optional

import torch

from ..config import TreeConfig
from ..ensemble import Ensemble
from .kernels import oblivious_leaf_sum_cuda, weighted_leaf_sum_cuda

DEFAULT_TREE_CHUNK = 512


def _chunk_size(capacity: int, requested: int) -> int:
    """Largest tree chunk <= requested that divides the capacity."""
    c = min(capacity, requested)
    while capacity % c != 0:
        c -= 1
    return max(c, 1)


def _column_value(f: torch.Tensor, X: torch.Tensor) -> torch.Tensor:
    """X[n, f[n, c]] -> [N, C] f32.  An empty X reads as 0, like the JAX
    one-hot select (such values are only used on nodes that never route)."""
    if X.shape[1] == 0:
        return torch.zeros(f.shape, dtype=torch.float32, device=f.device)
    return torch.gather(X, 1, f.clamp(max=X.shape[1] - 1))


def chunk_leaf_rel(feat, thr, cat_code, is_split, is_numeric,
                   Xn: torch.Tensor, Xc: Optional[torch.Tensor],
                   max_depth: int) -> torch.Tensor:
    """Heap-walk leaf indices for one chunk of trees -> [N, C] int64 in
    [0, 2^D).

    Routing matches node.cpp:77-96: numeric ``x > thr`` -> right,
    categorical ``code == cat_code`` -> right; pass-through nodes descend
    left.  ``feat`` is clamped to >= 0 before X is read (pass-through nodes
    carry -1)."""
    N = Xn.shape[0]
    C, IN = feat.shape
    dev = Xn.device
    has_cat = Xc is not None and Xc.shape[1] > 0
    base = (torch.arange(C, device=dev) * IN)[None, :]
    ft, th, sp = feat.reshape(-1), thr.reshape(-1), is_split.reshape(-1)
    p = torch.zeros((N, C), dtype=torch.long, device=dev)
    for _ in range(max_depth):
        idx = base + p
        f = ft[idx].long().clamp_(min=0)
        go = _column_value(f, Xn) > th[idx]
        if has_cat:
            numeric = is_numeric.reshape(-1)[idx]
            xc = torch.gather(Xc, 1, f.clamp(max=Xc.shape[1] - 1))
            go = torch.where(numeric, go, xc == cat_code.reshape(-1)[idx])
        p = 2 * p + 1 + (sp[idx] & go).long()
    return p - IN


def chunk_leaf_indices(feat, thr, cat_code, is_split, is_numeric,
                       Xn: torch.Tensor, Xc: Optional[torch.Tensor],
                       max_depth: int) -> torch.Tensor:
    """The JAX package's name for ``chunk_leaf_rel``: [N, C] leaf indices
    of a chunk of trees, on the tensors' device."""
    return chunk_leaf_rel(feat, thr, cat_code, is_split, is_numeric, Xn, Xc,
                          max_depth)


def _leaf_gather(lv: torch.Tensor, rel: torch.Tensor) -> torch.Tensor:
    """lv [C, L, O], rel [N, C] -> lv[c, rel[n, c], :] as [N, C, O]."""
    return lv[torch.arange(lv.shape[0], device=lv.device)[None, :], rel]


def weighted_leaf_sum(cfg: TreeConfig, ens: Ensemble, Xn: torch.Tensor,
                      coeff: torch.Tensor, Xc: Optional[torch.Tensor] = None,
                      tree_chunk: int = DEFAULT_TREE_CHUNK) -> torch.Tensor:
    """sum_t coeff[t, :] * leaf_value[t, leaf(n, t), :]  ->  [N, O].

    coeff [T_cap, O] must already be zero for trees outside the active range
    (t >= n_trees, or outside [start_idx, stop_idx))."""
    if Xc is None or Xc.shape[1] == 0:
        if Xn.shape[1] == 0:        # no columns read as 0, as in the walk
            Xn = torch.zeros((Xn.shape[0], 1), dtype=torch.float32,
                             device=Xn.device)
        leaf_sum = (oblivious_leaf_sum_cuda if cfg.grow_policy == "oblivious"
                    else weighted_leaf_sum_cuda)
        return leaf_sum(Xn.contiguous(), ens.feat, ens.thr, ens.is_split,
                        ens.leaf_values, cfg.max_depth, ens.n_trees,
                        coeff.contiguous())
    T = ens.capacity
    C = _chunk_size(T, tree_chunk)
    acc = torch.zeros((Xn.shape[0], cfg.output_dim), dtype=torch.float32,
                      device=Xn.device)
    for t0 in range(0, T, C):
        sl = slice(t0, t0 + C)
        rel = chunk_leaf_rel(ens.feat[sl], ens.thr[sl], ens.cat_code[sl],
                             ens.is_split[sl], ens.is_numeric[sl], Xn, Xc,
                             cfg.max_depth)
        w = ens.leaf_values[sl] * coeff[sl][:, None, :]
        acc = acc + _leaf_gather(w, rel).sum(dim=1)
    return acc


def gather_leaf_values(cfg: TreeConfig, ens: Ensemble, Xn: torch.Tensor,
                       Xc: Optional[torch.Tensor] = None,
                       tree_chunk: int = DEFAULT_TREE_CHUNK) -> torch.Tensor:
    """All per-(sample, tree) leaf values [N, T_cap, O] (for passes needing
    the full sequence). Memory: N*T_cap*O floats."""
    C = _chunk_size(ens.capacity, tree_chunk)
    parts = []
    for t0 in range(0, ens.capacity, C):
        sl = slice(t0, t0 + C)
        rel = chunk_leaf_rel(ens.feat[sl], ens.thr[sl], ens.cat_code[sl],
                             ens.is_split[sl], ens.is_numeric[sl], Xn, Xc,
                             cfg.max_depth)
        parts.append(_leaf_gather(ens.leaf_values[sl], rel))
    return torch.cat(parts, dim=1)


def single_tree_leaf_values(cfg: TreeConfig, tree: dict, Xn: torch.Tensor,
                            Xc: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Leaf values of ONE tree for all samples [N, O] (incremental predict)."""
    rel = chunk_leaf_rel(tree["feat"][None], tree["thr"][None],
                         tree["cat_code"][None], tree["is_split"][None],
                         tree["is_numeric"][None], Xn, Xc, cfg.max_depth)
    return tree["leaf_values"][rel[:, 0]]


def cv_momentum(cfg: TreeConfig, ens: Ensemble, Xn: torch.Tensor,
                Xc: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Control-variate momentum: bias-corrected EMA of per-sample leaf values
    over trees 0..n_trees (fitter.cpp:585-611, predictor.cpp:37-119).

    m_T = (1-beta) * sum_t beta^(T-1-t) * v_t, then * 1/sqrt(1-beta^T),
    expressed as a weighted leaf reduction."""
    dev = ens.device
    # filled on the device: a tensor made from a host scalar waits for it
    beta = torch.full((), cfg.cv_beta, dtype=torch.float32, device=dev)
    T = ens.capacity
    nt = ens.n_trees.to(torch.float32)
    t = torch.arange(T, dtype=torch.float32, device=dev)
    w = (1.0 - beta) * torch.pow(beta, torch.clamp(nt - 1.0 - t, min=0.0))
    w = torch.where(t < nt, w, torch.zeros_like(w))
    corr = 1.0 / torch.sqrt(1.0 - torch.pow(beta, nt))
    coeff = (w * corr)[:, None].expand(T, cfg.output_dim).contiguous()
    return weighted_leaf_sum(cfg, ens, Xn, coeff, Xc)
