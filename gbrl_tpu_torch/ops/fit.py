"""Tree fitting as level-synchronous histogram reductions (counterpart of
``gbrl_tpu/ops/fit.py``; reference src/cpp/fitter.cpp).

One per-sample ``node_rel`` vector says which node of the current level each
sample sits in; each level builds a gradient histogram over (feature, node,
bucket) and picks the split of every node from its bucket prefix sums.  Both
reference split scores collapse to expressions over per-child gradient sums
and counts:

- L2     (node.cpp:321-376):  ||sum_L||^2 / n_L + ||sum_R||^2 / n_R
- Cosine (math_ops.h:538-576): sqrt of the same quantity.

Tie-breaking is the reference's first-index argmax, with scores within a
2e-6 relative band treated as tied (``_first_argmax_tol``); numeric
candidates come before categorical ones.  Parent-score subtraction and the
>= 0 acceptance rule (greedy), the per-level summed score (oblivious), the
no-candidate-reuse rule, min_data_in_leaf and feature weights are all kept.
Trees are emitted in perfect-binary-heap layout; un-split nodes pass samples
left.  Leaf values are the masked mean of the *raw* gradients.

Dispatch in ``build_tree`` follows the JAX package on a TPU, without its
VMEM guards:

- numeric-only trees of depth <= 4 take the whole-tree path when the module
  hook ``_DISABLE_FUSED_TREE`` is False: one K6 launch per tree
  (``tree_build_cuda``);
- other numeric-only trees, and all of them by default (the JAX package's
  default, ``_DISABLE_FUSED_TREE = True``), take the level path: per level
  K2 (``level_histogram_cuda``) then K3 (``level_score_cuda``);
- trees with categorical columns take the general path in plain torch, with
  their histograms through the K2 wrapper (``_level_histogram``); like the
  level path it reads nothing back to the host and takes every shape from
  its arguments, so the fused PPO update on categorical codes replays it
  inside a CUDA graph (``rl/jit_update.py``).

Each wrapper from ``ops/kernels.py`` launches its kernel on CUDA tensors and
runs its plain version on CPU tensors.  Routing gathers directly where the
JAX package builds a one-hot matmul to avoid a TPU gather.  Leaf and node
sums are one-hot contractions as in the JAX package, in float64, so they
take a fixed order on every device (``index_add_`` adds with atomics on
CUDA).  Nothing here waits for the device: the level's split flags stay
tensors.
"""
from __future__ import annotations

from typing import Dict, Optional

import torch

from ..config import TreeConfig
from ..utils.profiling import span
from .kernels import (NPMAX, level_histogram_cuda, level_score_cuda,
                      tree_build_cuda)

NEG_INF = float("-inf")
# test hook, as in the JAX package: False sends numeric trees of depth
# <= 4 through K6, one launch per tree
_DISABLE_FUSED_TREE = True


def _l2_of_sum(s: torch.Tensor, n: torch.Tensor) -> torch.Tensor:
    """||sum||^2 / n, 0 where n == 0 (node.cpp:235-236)."""
    sq = torch.sum(s * s, dim=-1)
    safe_n = torch.where(n > 0, n, torch.ones_like(n))
    return torch.where(n > 0, sq / safe_n, torch.zeros_like(sq))


def _cosine(s: torch.Tensor) -> torch.Tensor:
    """sqrt(s) for s > 0, else 0 (math_ops.h:570)."""
    return torch.where(s > 0, torch.sqrt(torch.where(s > 0, s,
                                                     torch.ones_like(s))),
                       torch.zeros_like(s))


def split_scores(left_sum, left_cnt, right_sum, right_cnt, score: str,
                 min_data_in_leaf: int) -> torch.Tensor:
    """Candidate scores from child sums/counts. Shapes [..., O] and [...]."""
    s = _l2_of_sum(left_sum, left_cnt) + _l2_of_sum(right_sum, right_cnt)
    if score == "cosine":
        s = _cosine(s)
    if min_data_in_leaf > 0:
        bad = (left_cnt < min_data_in_leaf) | (right_cnt < min_data_in_leaf)
        s = torch.where(bad, torch.full_like(s, NEG_INF), s)
    return s


def node_scores(node_sum, node_cnt, score: str) -> torch.Tensor:
    """Whole-node (parent) score (split_candidate_generator.cpp:262-320)."""
    s = _l2_of_sum(node_sum, node_cnt)
    return _cosine(s) if score == "cosine" else s


def _nan_to_neginf(x: torch.Tensor) -> torch.Tensor:
    """NaN scores are never chosen by the reference's strict > scans."""
    return torch.where(torch.isnan(x), torch.full_like(x, NEG_INF), x)


def _first_argmax_tol(x: torch.Tensor, dim: int = -1,
                      scale: Optional[torch.Tensor] = None) -> torch.Tensor:
    """First-index argmax treating scores within 2e-6 relative of the max as
    tied (histogram sums perturb scores of equal partitions by a few ulps;
    the band restores the reference's first-wins order).  ``scale`` (the
    parent score, greedy levels below the root) adds to the band's base."""
    m = torch.amax(x, dim=dim, keepdim=True)
    base = m.abs() if scale is None else m.abs() + scale
    tol = torch.where(torch.isfinite(m), base * 2e-6, torch.zeros_like(m))
    return torch.argmax((x >= m - tol).to(torch.uint8), dim=dim)


def _weighted_rows(grads: torch.Tensor, sample_w: torch.Tensor) -> torch.Tensor:
    """[N, O + 1] rows (grads * w | w)."""
    return torch.cat([grads * sample_w[:, None], sample_w[:, None]], dim=-1)


def _node_expand(node_rel, build_grads, sample_w, n_nodes) -> torch.Tensor:
    """[N, O] rows spread over node columns: nd[n, node*(O+1)+c] =
    (node_rel[n] == node) * (grads | weight)[n, c].  Shape [N, n_nodes*(O+1)]."""
    N, O = build_grads.shape
    data = _weighted_rows(build_grads, sample_w)
    noh = (node_rel[:, None] == torch.arange(n_nodes, device=node_rel.device)
           [None, :]).to(torch.float32)
    return (noh[:, :, None] * data[:, None, :]).reshape(N, n_nodes * (O + 1))


def _level_histogram(Xb, node_rel, build_grads, sample_w, n_nodes,
                     n_buckets, mesh=None) -> torch.Tensor:
    """Per (feature, node, bucket) gradient sums and counts through K2:
    -> [F, n_nodes, n_buckets, O+1] (last column = counts), summed over
    the ranks of ``mesh`` when there is one."""
    F = Xb.shape[1]
    O = build_grads.shape[-1]
    nd = _node_expand(node_rel, build_grads, sample_w, n_nodes)
    hist = level_histogram_cuda(Xb.contiguous(), nd, n_buckets)
    if mesh is not None:
        hist = mesh.sum_ranks(hist)
    return hist.reshape(F, n_nodes, O + 1, n_buckets).transpose(2, 3)


def _route_level(Xb, Xc, node_rel, do_split, is_num_sel, f_num, b_num,
                 f_cat, c_cat) -> torch.Tensor:
    """Descend samples one level: numeric bucket > b (== x > thr), or code
    equality, read by a direct gather of each sample's node's feature."""
    has_num = Xb is not None and Xb.shape[1] > 0
    has_cat = Xc is not None and Xc.shape[1] > 0
    node = node_rel.long()
    if has_num:
        x = torch.gather(Xb, 1, f_num.long()[node][:, None])[:, 0]
        go = x > b_num[node]
    if has_cat:
        xc = torch.gather(Xc, 1, f_cat.long()[node][:, None])[:, 0]
        go_cat = xc == c_cat[node]
        go = torch.where(is_num_sel[node], go, go_cat) if has_num else go_cat
    go = go & do_split[node]
    return node_rel * 2 + go.to(torch.int32)


def _segment_sum(rows: torch.Tensor, seg: torch.Tensor, n_seg: int,
                 mesh=None) -> torch.Tensor:
    """[n_seg, C] sums of rows [N, C] by segment id: a one-hot contraction
    in float64 (summed over the ranks of ``mesh`` when there is one),
    rounded once to float32.  Deterministic on every device and untouched
    by the TF32 matmul setting."""
    oh = (seg[:, None] == torch.arange(n_seg, device=seg.device)[None, :])
    s = torch.mm(oh.to(torch.float64).T, rows.to(torch.float64))
    if mesh is not None:
        s = mesh.sum_ranks(s)
    return s.to(torch.float32)


def _node_stats(node_rel, build_grads, sample_w, n_nodes, mesh=None):
    O = build_grads.shape[-1]
    agg = _segment_sum(_weighted_rows(build_grads, sample_w), node_rel,
                       n_nodes, mesh)
    return agg[:, :O], agg[:, O]


def _general_level(cfg: TreeConfig, d: int, Xb, Xc, node_rel, build_grads,
                   sample_w, feat_w, cat_valid, feat_w_cat, blocked_num,
                   blocked_cat, n_nodes: int, F: int, Fc: int, V: int,
                   mesh=None):
    """One level of the general (categorical) path: adjusted candidate
    scores [n_nodes, F*B + Fc*V] plus node sums and counts (histograms and
    node sums over every rank of ``mesh``)."""
    B, O = cfg.n_bins, cfg.output_dim
    parts = []
    node_sum = node_cnt = None
    if F > 0:
        hist = _level_histogram(Xb, node_rel, build_grads, sample_w,
                                n_nodes, B + 1, mesh)  # [F, n, B+1, O+1]
        cs_all = torch.cumsum(hist, dim=2)
        # node totals are any feature's full marginal (feature 0)
        node_sum = cs_all[0, :, B, :O]
        node_cnt = cs_all[0, :, B, O]
        cs = cs_all[:, :, :B, :O]
        cc = cs_all[:, :, :B, O]
        right_sum = node_sum[None, :, None, :] - cs
        right_cnt = node_cnt[None, :, None] - cc
        sc = split_scores(cs, cc, right_sum, right_cnt, cfg.score,
                          cfg.min_data_in_leaf).transpose(0, 1)  # [n, F, B]
        if d > 0:
            sc = torch.where(blocked_num, torch.full_like(sc, NEG_INF), sc)
        parts.append((sc * feat_w[None, :, None]).reshape(n_nodes, F * B))
    if node_sum is None:
        node_sum, node_cnt = _node_stats(node_rel, build_grads, sample_w,
                                         n_nodes, mesh)
    chist = _level_histogram(Xc, node_rel, build_grads, sample_w, n_nodes, V,
                             mesh)
    right_sum, right_cnt = chist[..., :O], chist[..., O]  # right = code match
    left_sum = node_sum[None, :, None, :] - right_sum
    left_cnt = node_cnt[None, :, None] - right_cnt
    scc = split_scores(left_sum, left_cnt, right_sum, right_cnt, cfg.score,
                       cfg.min_data_in_leaf).transpose(0, 1)   # [n, Fc, V]
    scc = torch.where(cat_valid[None, :, :], scc,
                      torch.full_like(scc, NEG_INF))
    if d > 0:
        scc = torch.where(blocked_cat, torch.full_like(scc, NEG_INF), scc)
    parts.append((scc * feat_w_cat[None, :, None]).reshape(n_nodes, Fc * V))
    return torch.cat(parts, dim=1), node_sum, node_cnt


def build_tree(cfg: TreeConfig, Xb: Optional[torch.Tensor],
               cand_vals: Optional[torch.Tensor],
               grads: torch.Tensor, build_grads: torch.Tensor,
               sample_w: torch.Tensor, feat_w: torch.Tensor,
               Xc: Optional[torch.Tensor] = None,
               cat_valid: Optional[torch.Tensor] = None,
               feat_w_cat: Optional[torch.Tensor] = None,
               mesh=None) -> Dict[str, torch.Tensor]:
    """Fit one tree (arguments as ``gbrl_tpu.ops.fit.build_tree``).

    Xb [N, F] int32 bucket ids in [0, n_bins] (None when all-categorical);
    cand_vals [F, B] ascending thresholds; grads [N, O] raw gradients (leaf
    values); build_grads [N, O] scoring gradients; sample_w [N] 0/1 mask;
    feat_w [F]; Xc [N, Fc] int32 codes (code == c routes right); cat_valid
    [Fc, V] candidate mask; feat_w_cat [Fc].  With a ``mesh``
    (parallel/sharded.py) the rows are this rank's and every histogram,
    node sum and leaf sum is summed over the ranks (K2's output between K2
    and K3 on the level path), so every rank fits the same tree; the
    whole-tree path (K6) then raises when there is more than one rank.
    Returns a dict of per-tree tensors in heap layout.  One ``fit`` span
    (``utils/profiling.py``) records the call, with the path taken
    (``level``, ``k6`` or ``general``); the level and general paths add a
    ``fit.level`` span a depth."""
    has_num = Xb is not None and Xb.shape[1] > 0
    has_cat = Xc is not None and Xc.shape[1] > 0
    if (has_num and not has_cat and not _DISABLE_FUSED_TREE
            and (1 << (cfg.max_depth - 1)) <= NPMAX):
        if mesh is not None and mesh.world > 1:
            raise ValueError(
                "the whole-tree path (K6) fits a tree in one launch and "
                "cannot sum histograms over ranks between levels; with "
                f"samples sharded over {mesh.world} ranks set "
                "ops.fit._DISABLE_FUSED_TREE = True (the level path)")
        with span("fit", path="k6"):
            return _fused_tree(cfg, Xb, cand_vals, grads, build_grads,
                               sample_w, feat_w.to(torch.float32).contiguous())
    with span("fit", path="level" if has_num and not has_cat else "general"):
        return _level_tree(cfg, Xb, cand_vals, grads, build_grads, sample_w,
                           feat_w, Xc, cat_valid, feat_w_cat, mesh)


def _level_tree(cfg: TreeConfig, Xb, cand_vals, grads, build_grads,
                sample_w, feat_w, Xc, cat_valid, feat_w_cat,
                mesh) -> Dict[str, torch.Tensor]:
    """``build_tree`` level by level: per level K2 then K3 (numeric-only
    trees), or the general path in plain torch."""
    has_num = Xb is not None and Xb.shape[1] > 0
    has_cat = Xc is not None and Xc.shape[1] > 0
    N = Xb.shape[0] if has_num else Xc.shape[0]
    F = Xb.shape[1] if has_num else 0
    B = cfg.n_bins
    Fc = Xc.shape[1] if has_cat else 0
    V = cat_valid.shape[1] if has_cat else 0
    D = cfg.max_depth
    L = 1 << D
    O = cfg.output_dim
    dev = grads.device

    node_rel = torch.zeros((N,), dtype=torch.int32, device=dev)
    lv_feat, lv_thr, lv_code, lv_split, lv_isnum, lv_cnt = ([] for _ in range(6))
    # no-reuse rule (node.cpp:153-166) as per-node candidate masks: child
    # mask = parent mask | chosen candidate (by value, so duplicate grid
    # entries block together)
    blocked_num = (torch.zeros((1, F, B), dtype=torch.bool, device=dev)
                   if has_num else None)
    blocked_cat = (torch.zeros((1, Fc, V), dtype=torch.bool, device=dev)
                   if has_cat else None)
    alive = torch.ones((), dtype=torch.bool, device=dev)  # oblivious growth
    depth_reached = torch.zeros((), dtype=torch.int32, device=dev)
    fw = feat_w.to(torch.float32).contiguous() if has_num else None

    for d in range(D):
        with span("fit.level", d=d):
            n_nodes = 1 << d
            if has_num and not has_cat:
                # level path: K2 then K3
                nd = _node_expand(node_rel, build_grads, sample_w, n_nodes)
                hist = level_histogram_cuda(Xb, nd, B + 1)
                if mesh is not None:
                    # K2's rows -> global, for K3
                    hist = mesh.sum_ranks(hist)
                best_idx, best, node_cnt, _, _ = level_score_cuda(
                    hist, blocked_num.contiguous(), fw, B, O, cfg.score,
                    cfg.min_data_in_leaf, cfg.oblivious, d == 0)
                is_num_sel = torch.ones((n_nodes,), dtype=torch.bool,
                                        device=dev)
                if cfg.oblivious:
                    alive = alive & (best[0] > NEG_INF)
                    do_split = alive.expand(n_nodes)
                else:
                    do_split = (best >= 0) & (node_cnt > 0)
            else:
                adj, node_sum, node_cnt = _general_level(
                    cfg, d, Xb, Xc, node_rel, build_grads, sample_w, feat_w,
                    cat_valid, feat_w_cat, blocked_num, blocked_cat, n_nodes,
                    F, Fc, V, mesh)
                if cfg.oblivious:
                    total = _nan_to_neginf(torch.sum(adj, dim=0))
                    idx = _first_argmax_tol(total)
                    alive = alive & (total[idx] > NEG_INF)
                    best_idx = idx.to(torch.int32).expand(n_nodes)
                    do_split = alive.expand(n_nodes)
                else:
                    scale = None
                    if d > 0:
                        parent = node_scores(node_sum, node_cnt, cfg.score)
                        adj = adj - parent[:, None]
                        scale = parent.abs()[:, None]
                    adj = _nan_to_neginf(adj)
                    best_idx = _first_argmax_tol(adj, dim=1, scale=scale)
                    best = torch.gather(adj, 1, best_idx[:, None])[:, 0]
                    best_idx = best_idx.to(torch.int32)
                    # accept iff adjusted score >= 0 and the node holds samples
                    # (fitter.cpp:300-301, 357)
                    do_split = (best >= 0) & (node_cnt > 0)
                is_num_sel = (best_idx < F * B) if has_num else \
                    torch.zeros_like(best_idx, dtype=torch.bool)

            # decode the merged candidate index
            nidx = torch.clamp(best_idx, max=max(F * B - 1, 0))
            f_num = nidx // max(B, 1)
            b_num = nidx % max(B, 1)
            if has_cat:
                cidx = torch.clamp(best_idx - F * B, min=0)
                f_cat, c_cat = cidx // V, cidx % V
            else:
                f_cat = c_cat = torch.zeros_like(best_idx)
            v_sel = (cand_vals[f_num.long(), b_num.long()] if has_num else
                     torch.zeros((n_nodes,), dtype=torch.float32, device=dev))
            f_sel = torch.where(is_num_sel, f_num, f_cat)
            minus1 = torch.full_like(best_idx, -1)
            lv_feat.append(torch.where(do_split, f_sel, minus1))
            lv_thr.append(torch.where(do_split & is_num_sel, v_sel,
                                      torch.zeros_like(v_sel)))
            lv_code.append(torch.where(do_split & ~is_num_sel, c_cat, minus1))
            lv_isnum.append(is_num_sel)
            lv_split.append(do_split)
            lv_cnt.append(node_cnt)
            depth_reached = torch.where(do_split.any(), d + 1, depth_reached)

            node_rel = _route_level(Xb, Xc, node_rel, do_split, is_num_sel,
                                    f_num, b_num, f_cat, c_cat)

            # children inherit the parent's blocked mask plus the chosen split
            rep = torch.arange(2 * n_nodes, device=dev) // 2   # no host sync
            if has_num:
                chosen = ((do_split & is_num_sel)[:, None, None]
                          & (f_num[:, None, None]
                             == torch.arange(F, device=dev)[None, :, None])
                          & (v_sel[:, None, None] == cand_vals[None, :, :]))
                blocked_num = (blocked_num | chosen)[rep]
            if has_cat:
                chosen_c = ((do_split & ~is_num_sel)[:, None, None]
                            & (f_cat[:, None, None]
                               == torch.arange(Fc, device=dev)[None, :, None])
                            & (c_cat[:, None, None]
                               == torch.arange(V, device=dev)[None, None, :]))
                blocked_cat = (blocked_cat | chosen_c)[rep]

    # leaf values = masked mean of raw gradients (fitter.cpp:545-582)
    leaf = _segment_sum(_weighted_rows(grads, sample_w), node_rel, L, mesh)
    return _tree_dict(lv_feat, lv_thr, lv_code, lv_split, lv_isnum, lv_cnt,
                      leaf, O, depth_reached)


def _tree_dict(lv_feat, lv_thr, lv_code, lv_split, lv_isnum, lv_cnt,
               leaf: torch.Tensor, O: int, depth: torch.Tensor) -> dict:
    """The per-tree dict from the per-level lists and the leaf sums [L,
    O + 1] (counts in the last column)."""
    leaf_cnt = leaf[:, O]
    safe = torch.where(leaf_cnt > 0, leaf_cnt, torch.ones_like(leaf_cnt))
    leaf_values = torch.where(leaf_cnt[:, None] > 0, leaf[:, :O] / safe[:, None],
                              torch.zeros_like(leaf[:, :O]))
    return dict(
        feat=torch.cat(lv_feat),
        thr=torch.cat(lv_thr),
        cat_code=torch.cat(lv_code),
        is_split=torch.cat(lv_split),
        is_numeric=torch.cat(lv_isnum),
        leaf_values=leaf_values,
        counts=torch.cat(lv_cnt + [leaf_cnt]),
        depth=depth,
    )


def _fused_tree(cfg: TreeConfig, Xb, cand_vals, grads, build_grads, sample_w,
                fw) -> dict:
    """The whole-tree path (gbrl_tpu/ops/fit.py:277-331): one K6 launch,
    then its per-level choices decoded into heap-layout fields, on the
    device."""
    B, O, D = cfg.n_bins, cfg.output_dim, cfg.max_depth
    best_idx, do_split, stats, leaf = tree_build_cuda(
        Xb.contiguous(), cand_vals.contiguous(), fw,
        _weighted_rows(build_grads, sample_w).contiguous(),
        _weighted_rows(grads, sample_w).contiguous(), D, B, O, cfg.score,
        cfg.min_data_in_leaf, cfg.oblivious)
    lv_feat, lv_thr, lv_code, lv_split, lv_isnum, lv_cnt = ([] for _ in range(6))
    depth_reached = torch.zeros((), dtype=torch.int32, device=Xb.device)
    for d in range(D):
        k = 1 << d
        split = do_split[d, :k]
        f_num = best_idx[d, :k] // B
        v_sel = cand_vals[f_num.long(), (best_idx[d, :k] % B).long()]
        lv_feat.append(torch.where(split, f_num, torch.full_like(f_num, -1)))
        lv_thr.append(torch.where(split, v_sel, torch.zeros_like(v_sel)))
        lv_code.append(torch.full_like(f_num, -1))
        lv_isnum.append(torch.ones_like(split))
        lv_split.append(split)
        lv_cnt.append(stats[d, :k, 1])
        depth_reached = torch.where(split.any(), d + 1, depth_reached)
    return _tree_dict(lv_feat, lv_thr, lv_code, lv_split, lv_isnum, lv_cnt,
                      leaf, O, depth_reached)


def standardize_l2(build_grads: torch.Tensor, sample_w: torch.Tensor,
                   mesh=None) -> torch.Tensor:
    """Per-column standardization of the L2 score (fitter.cpp:58-64: center
    then divide by sqrt(var / (n - 1))); zero-variance columns divide by 1.
    With a ``mesh`` the rows are this rank's and n, the mean and the
    variance are the global ones."""
    s = torch.cat([torch.sum(sample_w).reshape(1),
                   torch.sum(build_grads * sample_w[:, None], dim=0)])
    if mesh is not None:
        s = mesh.sum_ranks(s)
    n = s[0]
    mean = s[1:] / torch.clamp(n, min=1.0)
    centered = (build_grads - mean[None, :]) * sample_w[:, None]
    sq = torch.sum(centered * centered, dim=0)
    if mesh is not None:
        sq = mesh.sum_ranks(sq)
    var = sq / torch.clamp(n - 1.0, min=1.0)
    std = torch.sqrt(var)
    std = torch.where(std > 0, std, torch.ones_like(std))
    return centered / std[None, :]
