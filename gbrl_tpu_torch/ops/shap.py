"""TreeSHAP for heap-layout GBT ensembles (host-side numpy; counterpart of
``gbrl_tpu/ops/shap.py``, kept as written there).

The reference implements Linear TreeSHAP (Yu et al. 2023, shap.cpp:259-333)
with Chebyshev polynomial bases; here we use the classic path-dependent
TreeSHAP recursion (Lundberg et al. 2018, Algorithm 2), which computes the
exact same Shapley values of the same value function — the tree's
conditional expectation with edge weights = child_count/parent_count
recorded at fit time (node.cpp:131,141) — validated in tests against
brute-force exact Shapley enumeration.  It is the oracle that the device
form (``ops/shap_device.py``) is held against.

Semantics mirror the reference's entry points (gbrl.cpp:1269-1342):
- the explained function is the tree's RAW leaf values (mean gradients), no
  bias / learning-rate scaling;
- ensemble_shap is the sum of per-tree SHAP values;
- output shape [n_samples, input_dim, output_dim] with features in internal
  order (numeric block, then categorical block).

``ens`` is the port's ``Ensemble`` (tensors on any device, copied to the
host once per call) or a dict of its numpy arrays (``ensemble_to_numpy``).
"""
from __future__ import annotations

import itertools
from math import factorial
from typing import Optional

import numpy as np

from ..config import TreeConfig
from ..ensemble import host_arrays


class _Node:
    __slots__ = ("feat", "thr", "is_num", "code", "left", "right",
                 "w_left", "w_right", "value")

    def __init__(self):
        self.feat = -1
        self.value = None


def extract_tree(cfg: TreeConfig, ens, tree_idx: int) -> _Node:
    """Heap arrays -> pruned node tree (pass-through nodes become leaves)."""
    arrs = host_arrays(ens)
    feat = arrs["feat"][tree_idx]
    thr = arrs["thr"][tree_idx]
    is_split = arrs["is_split"][tree_idx]
    is_num = arrs["is_numeric"][tree_idx]
    code = arrs["cat_code"][tree_idx]
    lv = np.asarray(arrs["leaf_values"][tree_idx], dtype=np.float64)
    counts = np.asarray(arrs["counts"][tree_idx], dtype=np.float64)
    D = cfg.max_depth
    L = 1 << D

    def build(p: int, depth: int) -> _Node:
        node = _Node()
        if depth == D or not is_split[p]:
            q = p
            for _ in range(depth, D):
                q = 2 * q + 1
            node.value = lv[q - (L - 1)]
            return node
        node.feat = int(feat[p])
        node.thr = float(thr[p])
        node.is_num = bool(is_num[p])
        node.code = int(code[p])
        cl, cr = 2 * p + 1, 2 * p + 2
        parent_n = counts[p]
        node.w_left = counts[cl] / parent_n if parent_n > 0 else 0.0
        node.w_right = counts[cr] / parent_n if parent_n > 0 else 0.0
        node.left = build(cl, depth + 1)
        node.right = build(cr, depth + 1)
        return node

    return build(0, 0)


def _shap_recurse(node: _Node, x_num, x_cat, phi, cat_offset: int):
    """Classic TreeSHAP: maintain the path of (feature, zero_frac, one_frac)
    with subset weights, unwinding duplicate features.  Categorical
    features are attributed at ``cat_offset`` + their block index."""

    def extend(m, pz, po, pd):
        # m: list of [d, z, o, w]
        m = [list(e) for e in m] + [[pd, pz, po, 0.0]]
        l = len(m) - 1
        m[l][3] = 1.0 if l == 0 else 0.0
        for i in range(l - 1, -1, -1):
            m[i + 1][3] += po * m[i][3] * (i + 1) / (l + 1)
            m[i][3] = pz * m[i][3] * (l - i) / (l + 1)
        return m

    def unwind(m, i):
        l = len(m) - 1
        pz, po = m[i][1], m[i][2]
        m = [list(e) for e in m]
        n = m[l][3]
        for j in range(l - 1, -1, -1):
            if po != 0:
                t = m[j][3]
                m[j][3] = n * (l + 1) / ((j + 1) * po)
                n = t - m[j][3] * pz * (l - j) / (l + 1)
            else:
                m[j][3] = (m[j][3] * (l + 1)) / (pz * (l - j))
        for j in range(i, l):
            m[j][0], m[j][1], m[j][2] = m[j + 1][0], m[j + 1][1], m[j + 1][2]
        return m[:-1]

    def unwound_sum(m, i):
        l = len(m) - 1
        pz, po = m[i][1], m[i][2]
        total = 0.0
        n = m[l][3]
        for j in range(l - 1, -1, -1):
            if po != 0:
                t = n * (l + 1) / ((j + 1) * po)
                total += t
                n = m[j][3] - t * pz * (l - j) / (l + 1)
            else:
                total += m[j][3] * (l + 1) / (pz * (l - j))
        return total

    def goes_right(node: _Node) -> bool:
        if node.is_num:
            return x_num[node.feat] > node.thr
        return x_cat[node.feat] == node.code

    def recurse(node: _Node, m, pz, po, pd):
        if pz == 0.0 and po == 0.0:
            # zero-cover subtree: every downstream subset weight carries a
            # factor of pz or po, so the contribution is identically zero
            # (guards the 0/0 in unwind for empty oblivious children)
            return
        m = extend(m, pz, po, pd)
        if node.value is not None:
            for i in range(1, len(m)):
                w = unwound_sum(m, i)
                phi[m[i][0]] += w * (m[i][2] - m[i][1]) * node.value
            return
        if goes_right(node):
            hot, cold = node.right, node.left
            rh, rc = node.w_right, node.w_left
        else:
            hot, cold = node.left, node.right
            rh, rc = node.w_left, node.w_right
        f = node.feat if node.is_num else cat_offset + node.feat
        iz, io = 1.0, 1.0
        k = next((i for i in range(1, len(m)) if m[i][0] == f), 0)
        if k != 0:
            iz, io = m[k][1], m[k][2]
            m = unwind(m, k)
        recurse(hot, m, iz * rh, io, f)
        recurse(cold, m, iz * rc, 0.0, f)

    recurse(node, [], 1.0, 1.0, -1)


def tree_shap_values(cfg: TreeConfig, ens, tree_idx: int,
                     Xn, Xc: Optional[np.ndarray] = None) -> np.ndarray:
    """SHAP values of one tree: [n_samples, input_dim, output_dim]."""
    Xn = np.asarray(Xn, dtype=np.float64)
    if Xn.ndim == 1:
        Xn = Xn[None, :]
    Xc_np = (np.asarray(Xc) if Xc is not None
             else np.zeros((Xn.shape[0], 0), dtype=np.int32))
    n_num = Xn.shape[1]
    n_cat = Xc_np.shape[1]
    root = extract_tree(cfg, ens, tree_idx)
    N = Xn.shape[0]
    out = np.zeros((N, n_num + n_cat, cfg.output_dim))
    for i in range(N):
        _shap_recurse(root, Xn[i], Xc_np[i], out[i], n_num)
    return out.astype(np.float32)


def ensemble_shap_values(cfg: TreeConfig, ens, Xn,
                         Xc: Optional[np.ndarray] = None) -> np.ndarray:
    """Sum of per-tree SHAP values over the ensemble (gbrl.cpp:1305-1342)."""
    arrs = host_arrays(ens)
    n_trees = int(arrs["n_trees"])
    Xn = np.asarray(Xn, dtype=np.float64)
    if Xn.ndim == 1:
        Xn = Xn[None, :]
    total = None
    for t in range(n_trees):
        v = tree_shap_values(cfg, arrs, t, Xn, Xc)
        total = v if total is None else total + v
    if total is None:
        n_cat = 0 if Xc is None else np.asarray(Xc).shape[1]
        total = np.zeros((Xn.shape[0], Xn.shape[1] + n_cat, cfg.output_dim),
                         dtype=np.float32)
    return total


def brute_force_shap(cfg: TreeConfig, ens, tree_idx: int,
                     x_num: np.ndarray,
                     x_cat: Optional[np.ndarray] = None) -> np.ndarray:
    """Exact Shapley values by subset enumeration (test oracle only).

    v(S) = conditional expectation of the tree with features outside S
    marginalized by edge weights (Lundberg EXPVALUE semantics)."""
    root = extract_tree(cfg, ens, tree_idx)
    n_num = len(x_num)
    n_cat = 0 if x_cat is None else len(x_cat)
    F = n_num + n_cat

    def expvalue(node: _Node, S) -> np.ndarray:
        if node.value is not None:
            return node.value
        f = node.feat if node.is_num else n_num + node.feat
        if f in S:
            if node.is_num:
                child = node.right if x_num[node.feat] > node.thr else node.left
            else:
                child = node.right if x_cat[node.feat] == node.code else node.left
            return expvalue(child, S)
        return (node.w_left * expvalue(node.left, S)
                + node.w_right * expvalue(node.right, S))

    phi = np.zeros((F, cfg.output_dim))
    feats = list(range(F))
    for i in feats:
        rest = [f for f in feats if f != i]
        for r in range(len(rest) + 1):
            for S in itertools.combinations(rest, r):
                wgt = (factorial(len(S)) * factorial(F - len(S) - 1)
                       / factorial(F))
                phi[i] += wgt * (expvalue(root, set(S) | {i})
                                 - expvalue(root, set(S)))
    return phi
