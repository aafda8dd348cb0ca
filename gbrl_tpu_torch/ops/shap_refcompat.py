r"""Reference-compatible Linear TreeSHAP (host, numpy, vectorized over
samples; counterpart of ``gbrl_tpu/ops/shap_refcompat.py``, kept as written
there: the ensemble's fields are copied to the host once per call).

``ops/shap_device.py`` computes **exact** path-dependent TreeSHAP (verified
against brute-force Shapley enumeration), which is what the ``shap``
package's ``TreeExplainer`` computes — the reference's own external
validation bar (the reference's tests/test_gbt_single.py:226-250).

The reference's C++ implementation (shap.cpp:259-333, per Linear TreeShap,
Yu et al. 2023) **deviates from exact Shapley when a feature repeats along a
path and the repeated edges are not adjacent**: its nearest-ancestor lookup
(shap.cpp:128-146) attaches the correction to the *immediate parent* node's
edge (``feature_parent_node[c] = parent_idx`` and
``weights[c] *= weights[parent_idx]``) even when the same-feature ancestor
edge is further up, so the division polynomial and subtracted term use the
wrong edge's probability.  On a depth-4 oblivious tree with level
features [0,1,0,1] the reference differs from brute-force Shapley by up to
0.26, while the exact device form matches it
(tests/test_shap_golden.py::test_shap_exact_on_imported_models, for the
JAX package).

For users migrating reference models who need *bit-level* agreement with
the reference's ``ensemble_shap``/``tree_shap`` outputs, this module
replicates the reference recursion faithfully — including the
nearest-ancestor convention — operating on this framework's heap-layout
ensembles.  It reproduces:

* ``alloc_shap_data``            (shap.cpp:39-168)  -> ``_build_tree``
* ``linear_tree_shap``           (shap.cpp:259-333) -> ``_recurse``
* ``add_edge_shapley``           (shap.cpp:343-354)
* ``subtract_closest_parent_edge_shapley`` (shap.cpp:356-364)
* ``get_poly_vectors``           (gbrl/common/utils.py:343-371)
"""
from __future__ import annotations

from typing import List, Optional

import numpy as np

from ..ensemble import host_arrays


def reference_poly_vectors(max_depth: int):
    """The reference's exact polynomial fixtures
    (gbrl/common/utils.py:317-372): Chebyshev points of the 2nd kind scaled
    to [2, 3], Vandermonde-inverse norm rows, and the offset matrix."""
    from scipy.special import binom
    base_poly = np.polynomial.chebyshev.chebpts2(max_depth).astype(np.float32)
    base_poly = (base_poly + 1) * 0.5 + 2.0
    depth = base_poly.shape[0]
    norm_values = np.zeros((depth + 1, depth))
    for i in range(1, depth + 1):
        norm_weights = binom(i - 1, np.arange(i))
        norm_values[i, :i] = np.linalg.inv(
            np.vander(base_poly[:i]).T).dot(1.0 / norm_weights)
    offset = np.vander(base_poly + 1).T[::-1]
    return (base_poly.astype(np.float32), norm_values.astype(np.float32),
            offset.astype(np.float32))


class _Tree:
    """Explicit-node tree in the reference's DFS preorder (left-first),
    mirroring the arrays alloc_shap_data builds (shap.cpp:39-168)."""

    __slots__ = ("parents", "left", "right", "feature", "threshold", "code",
                 "numeric", "weights", "feature_parent", "max_unique",
                 "predictions", "n_nodes")

    def __init__(self):
        self.parents: List[int] = []
        self.left: List[int] = []
        self.right: List[int] = []
        self.feature: List[int] = []
        self.threshold: List[float] = []
        self.code: List[int] = []
        self.numeric: List[bool] = []
        self.weights: List[float] = []
        self.feature_parent: List[int] = []
        self.max_unique: List[int] = []
        self.predictions: List[np.ndarray] = []
        self.n_nodes = 0


def _leftmost_leaf(p: int, depth: int, D: int) -> int:
    q = p
    for _ in range(depth, D):
        q = 2 * q + 1
    return q - ((1 << D) - 1)


def _build_tree(D: int, feat, thr, code, is_split, is_numeric, counts,
                leaf_values) -> _Tree:
    """Heap arrays -> reference shap_data structure.

    Edge weights are recovered as counts[child]/counts[parent] — identical
    to the per-leaf ``edge_weights`` the reference stores at fit time
    (node.cpp:131,141).  Leaf predictions are pre-multiplied by the path's
    conditional probability, as in shap.cpp:119-123."""
    L = 1 << D
    t = _Tree()
    out_dim = leaf_values.shape[-1]
    # DFS stack of (heap_idx, depth, parent_dfs, is_left, is_right, path)
    stack = [(0, 0, -1, False, False, [])]
    root_count = float(counts[0]) if counts[0] > 0 else 1.0
    while stack:
        heap, depth, parent, is_left, is_right, path = stack.pop()
        idx = t.n_nodes
        t.n_nodes += 1
        t.parents.append(parent)
        t.left.append(-1)
        t.right.append(-1)
        t.feature.append(-1)
        t.threshold.append(np.inf)
        t.code.append(-1)
        t.numeric.append(True)
        t.feature_parent.append(-1)
        t.max_unique.append(0)
        t.predictions.append(np.zeros(out_dim, dtype=np.float32))
        if depth > 0:
            pheap = (heap - 1) // 2
            pcount = float(counts[pheap])
            t.weights.append(float(counts[heap]) / pcount
                             if pcount > 0 else 0.0)
        else:
            t.weights.append(1.0)
        if is_left:
            t.left[parent] = idx
        if is_right:
            t.right[parent] = idx
        if depth < D and bool(is_split[heap]):
            # internal: push right then left (left pops first), as the
            # reference does (shap.cpp:92-97)
            f = int(feat[heap])
            t.feature[idx] = f
            t.numeric[idx] = bool(is_numeric[heap])
            if t.numeric[idx]:
                t.threshold[idx] = float(thr[heap])
            else:
                t.code[idx] = int(code[heap])
            stack.append((2 * heap + 2, depth + 1, idx, False, True,
                          path + [f]))
            stack.append((2 * heap + 1, depth + 1, idx, True, False,
                          path + [f]))
        else:
            # leaf: value lives at the leftmost heap descendant
            leaf_rel = _leftmost_leaf(heap, depth, D)
            cond_prob = (float(counts[heap]) / root_count
                         if depth > 0 else 1.0)
            t.predictions[idx] = (np.asarray(leaf_values[leaf_rel],
                                             dtype=np.float32) * cond_prob)
            n_unique = len(set(path))
            # backtrack max_unique (shap.cpp:108-117)
            t.max_unique[idx] = max(t.max_unique[idx], n_unique)
            p = parent
            while p >= 0:
                if n_unique > t.max_unique[p]:
                    t.max_unique[p] = n_unique
                p = t.parents[p]
        # nearest-ancestor duplicate convention (shap.cpp:128-146):
        # prev_feature is the feature of the edge entering THIS node; if any
        # ancestor STRICTLY ABOVE the parent splits on it, the correction is
        # attached to the PARENT node (even if the matching edge is higher)
        if parent >= 0:
            prev_feature = t.feature[parent]
            g = t.parents[parent]
            found = False
            while g >= 0:
                if t.feature[g] == prev_feature:
                    found = True
                    break
                g = t.parents[g]
            if found:
                t.feature_parent[idx] = parent
                t.weights[idx] *= t.weights[parent]
    return t


def _tree_shap_compat(t: _Tree, D: int, out_dim: int, Xn, Xc,
                      base_poly, norm_values, offset_poly, shap_out):
    """One tree's contribution, vectorized over samples.

    ``shap_out`` is [N, F_total, O], accumulated in place.  Follows
    linear_tree_shap (shap.cpp:259-333) line by line; per-sample state is
    the leading axis of every array."""
    N = Xn.shape[0]
    active = np.zeros((N, t.n_nodes), dtype=bool)
    # C, G: [N, D+1 rows, D cols, O]
    C = np.zeros((N, D + 1, D, out_dim), dtype=np.float32)
    G = np.zeros((N, D + 1, D, out_dim), dtype=np.float32)
    C[:, 0] = 1.0

    def recurse(c: int, depth: int, crnt_feature: int):
        fpn = t.feature_parent[c]
        p_e_ancestor = np.zeros(N, dtype=np.float32)
        if fpn >= 0:
            active[:, c] &= active[:, fpn]
            active[:, c] &= t.weights[c] > 0.0
            if t.weights[fpn] > 0.0:
                p_e_ancestor = np.where(active[:, fpn],
                                        np.float32(1.0 / t.weights[fpn]),
                                        np.float32(0.0))
        p_e = np.zeros(N, dtype=np.float32)
        if crnt_feature >= 0:
            if t.weights[c] > 0.0:
                p_e = np.where(active[:, c], np.float32(1.0 / t.weights[c]),
                               np.float32(0.0))
            C[:, depth] = (C[:, depth - 1]
                           * (base_poly[None, :, None] + p_e[:, None, None]))
            if fpn >= 0:
                C[:, depth] = C[:, depth] / (base_poly[None, :, None]
                                             + p_e_ancestor[:, None, None])
        left, right = t.left[c], t.right[c]
        if left < 0 and right < 0:
            G[:, depth] = C[:, depth] * t.predictions[c][None, None, :]
        else:
            if t.numeric[c]:
                is_greater = Xn[:, t.feature[c]] > t.threshold[c]
            else:
                is_greater = Xc[:, t.feature[c]] == t.code[c]
            active[:, right] = is_greater
            active[:, left] = ~is_greater
            recurse(left, depth + 1, t.feature[c])
            pd = t.max_unique[c] - t.max_unique[left]
            G[:, depth + 1] *= offset_poly[pd][None, :, None]
            G[:, depth] = G[:, depth + 1]
            recurse(right, depth + 1, t.feature[c])
            pd = t.max_unique[c] - t.max_unique[right]
            G[:, depth + 1] *= offset_poly[pd][None, :, None]
            G[:, depth] = G[:, depth] + G[:, depth + 1]
        if crnt_feature >= 0:
            if fpn >= 0:
                mask = active[:, fpn]          # early return per sample
            else:
                mask = np.ones(N, dtype=bool)
            d = t.max_unique[c]
            if d > 0:
                # add_edge_shapley (shap.cpp:343-354)
                tmp = np.sum(G[:, depth, :d]
                             * (offset_poly[0, :d][None, :, None]
                                * norm_values[d, :d][None, :, None])
                             / (base_poly[None, :d, None]
                                + p_e[:, None, None]), axis=1) / d
                contrib = tmp * (p_e - 1.0)[:, None] * mask[:, None]
                shap_out[:, crnt_feature] += contrib
            if fpn >= 0:
                dp = t.max_unique[fpn]
                pd = dp - t.max_unique[c]
                if dp > 0:
                    tmp = np.sum(G[:, depth, :dp]
                                 * (offset_poly[pd, :dp][None, :, None]
                                    * norm_values[dp, :dp][None, :, None])
                                 / (base_poly[None, :dp, None]
                                    + p_e_ancestor[:, None, None]),
                                 axis=1) / dp
                    contrib = (tmp * (p_e_ancestor - 1.0)[:, None]
                               * mask[:, None])
                    shap_out[:, crnt_feature] -= contrib

    recurse(0, 0, -1)


def ensemble_shap_ref_compat(cfg, ens, Xn: np.ndarray,
                             Xc: Optional[np.ndarray] = None,
                             tree_idx: Optional[int] = None) -> np.ndarray:
    """SHAP values with the reference's exact conventions:
    [N, n_features, output_dim].  ``tree_idx`` limits to one tree
    (tree_shap); otherwise all active trees (ensemble_shap)."""
    D = cfg.max_depth
    O = cfg.output_dim
    Xn = np.asarray(Xn, dtype=np.float32)
    N = Xn.shape[0]
    n_features = Xn.shape[1] + (0 if Xc is None else Xc.shape[1])
    base_poly, norm_values, offset_poly = reference_poly_vectors(D)
    arrs = host_arrays(ens)
    feat = arrs["feat"]
    thr = arrs["thr"]
    code = arrs["cat_code"]
    spl = arrs["is_split"]
    num = arrs["is_numeric"]
    counts = arrs["counts"]
    lv = arrs["leaf_values"]
    n_trees = int(arrs["n_trees"])
    trees = [tree_idx] if tree_idx is not None else range(n_trees)
    out = np.zeros((N, n_features, O), dtype=np.float32)
    for ti in trees:
        t = _build_tree(D, feat[ti], thr[ti], code[ti], spl[ti], num[ti],
                        counts[ti], lv[ti])
        _tree_shap_compat(t, D, O, Xn, Xc, base_poly, norm_values,
                          offset_poly, out)
    return out
