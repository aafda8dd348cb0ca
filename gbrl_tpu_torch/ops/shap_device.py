r"""Device TreeSHAP for fixed-depth heap ensembles, in PyTorch on the
ensemble's device (counterpart of ``gbrl_tpu/ops/shap_device.py``, which is
XLA, not a Pallas kernel; this is its closed form as plain tensor math).

The reference computes SHAP on the CPU only (gbrl.cpp:1271-1278 copies GPU
ensembles to host first) with a per-sample recursion (shap.cpp:259-333).
Fixed-depth heap trees admit a fully vectorized closed form instead:

For path-dependent TreeSHAP, the tree's conditional expectation given a
feature subset S factorizes per leaf,

    E[f | S] = sum_l value_l * prod_{e in path(l)}
                   ([x follows e]      if feat(e) in S
                    else  w_e = n_child / n_parent),

so after grouping a leaf's path edges by feature (a feature may repeat with
different thresholds) into "slots" with

    hot_u  = prod of follow-indicators of u's edges   (per sample)
    cold_u = prod of edge weights of u's edges        (static)

the exact Shapley value of slot j in leaf l is the |U|-feature Shapley sum

    phi_j(l) = sum over S subseteq U minus {j} of  |S|! (k-|S|-1)! / k!
               * (prod_{s in S} hot_s) * (prod_{s in U\S, s != j} cold_s)
               * (hot_j - cold_j) * value_l,         k = |U|.

Layout on the device: trees are processed a chunk at a time, every
per-sample tensor is [N, T_c, L] (one per depth slot), and the chunk size
T_c is chosen from N, L and D so that a chunk's temporaries stay within
``CHUNK_BYTES``.  What does not depend on the samples (edge weights, the
duplicate-feature fold, the subset coefficients) is computed once per call
for all live trees.  The follow-indicators and their subset products are
exact 0/1 values, kept as booleans; the arithmetic is the JAX package's, in
float32, with the fold in its order.  The slots are scattered to features
and weighted by the leaf values in float32 matmuls, one per slot and chunk
(PyTorch's default precision: no TF32).  A call reads ``n_trees`` once and copies
nothing else to the host; no step waits for the device per tree or chunk.
"""
from __future__ import annotations

import math
from typing import List, Optional

import numpy as np
import torch

from ..config import TreeConfig
from ..ensemble import Ensemble

# upper bound on one chunk's temporaries (bytes)
CHUNK_BYTES = 1 << 30


def _weight_table(D: int) -> List[List[float]]:
    """W[s][k] = s! (k-s-1)! / k!  for 0 <= s < k <= D (0 elsewhere), each
    value rounded to float32 as the JAX package's table is."""
    W = [[0.0] * (D + 2) for _ in range(D + 1)]
    for k in range(1, D + 1):
        for s in range(k):
            v = (math.factorial(s) * math.factorial(k - s - 1)
                 / math.factorial(k))
            W[s][k] = float(np.float32(v))
    return W


def chunk_trees(N: int, D: int, n_trees: int, n_features: int,
                output_dim: int) -> int:
    """Trees per chunk: as many as keep the chunk's temporaries (about
    9 D + 20 bytes per sample, leaf and tree, plus the scatter matrix)
    within CHUNK_BYTES."""
    L = 1 << D
    per_tree = N * L * (9 * D + 20) + L * n_features * output_dim * 4
    return max(1, min(n_trees, CHUNK_BYTES // per_tree))


def _lookup(k: torch.Tensor, row: List[float]) -> torch.Tensor:
    """row[k] as float32 for an integer tensor k, built from Python scalars
    (no host-to-device copy)."""
    out = torch.zeros(k.shape, dtype=torch.float32, device=k.device)
    for kk, v in enumerate(row):
        if v != 0.0:
            out = torch.where(k == kk, v, out)
    return out


class _Statics:
    """The sample-independent part of a call, for the ensemble's first
    ``n_trees`` trees: heap paths, per-slot validity, features and edge weights after
    the duplicate fold, the fold's masks in order, and the subset
    coefficients ``coef[(subset, j)] = W[|S|, k] * ok * prod cold``."""

    def __init__(self, cfg: TreeConfig, ens: Ensemble, n_trees: int,
                 n_num: int):
        D = cfg.max_depth
        L = 1 << D
        P = L - 1
        dev = ens.feat.device
        leaf = torch.arange(L, device=dev)
        # static heap paths: leaf l passes internal node node[d][l] at depth
        # d and turns right there when right[d][l]
        self.node = [(1 << d) - 1 + (leaf >> (D - d)) for d in range(D)]
        self.right = [((leaf >> (D - 1 - d)) & 1).bool() for d in range(D)]
        child = [2 * self.node[d] + 1 + self.right[d].long()
                 for d in range(D)]
        feat = ens.feat[:n_trees, :P]
        is_split = ens.is_split[:n_trees, :P]
        is_num = ens.is_numeric[:n_trees, :P]
        counts = ens.counts[:n_trees]
        self.valid0 = [is_split[:, self.node[d]] for d in range(D)]  # [T, L]
        valid = list(self.valid0)
        slot, cold = [], []
        for d in range(D):
            pfeat = feat[:, self.node[d]]
            sf = torch.where(is_num[:, self.node[d]], pfeat, pfeat + n_num)
            slot.append(torch.where(valid[d], sf, -1))
            pc = counts[:, self.node[d]]
            cc = counts[:, child[d]]
            # counts may be absolute sample counts (the fitter) or path
            # probabilities in (0, 1] (models imported from the reference
            # format): guard the division without flooring the divisor
            c = torch.where(pc > 0, cc / torch.where(pc > 0, pc, 1.0), 0.0)
            cold.append(torch.where(valid[d], c, 1.0))
        # fold repeated features into their first slot, in the JAX
        # package's order (unrolled D^2 compares)
        self.dups = []
        for j in range(1, D):
            for i in range(j):
                dup = valid[i] & valid[j] & (slot[i] == slot[j])
                cold[i] = cold[i] * torch.where(dup, cold[j], 1.0)
                cold[j] = torch.where(dup, 1.0, cold[j])
                valid[j] = valid[j] & ~dup
                slot[j] = torch.where(dup, -1, slot[j])
                self.dups.append((i, j, dup))
        self.cold = cold
        self.validf = [v.float() for v in valid]
        self.slot = torch.stack(slot, dim=-1)                      # [T, L, D]
        k = torch.stack(valid, dim=-1).sum(dim=-1)                 # [T, L]
        W = _weight_table(D)
        self.coef = {}
        for t in range(1 << D):
            bits = [(t >> s) & 1 for s in range(D)]
            ok = torch.ones(k.shape, dtype=torch.bool, device=dev)
            for s in range(D):
                if bits[s]:
                    ok = ok & valid[s]
            w_t = _lookup(k, W[sum(bits)]) * ok
            for j in range(D):
                if bits[j]:
                    continue
                coldP = torch.ones(k.shape, dtype=torch.float32, device=dev)
                for s in range(D):
                    if s == j or bits[s]:
                        continue
                    coldP = coldP * cold[s]
                self.coef[(t, j)] = w_t * coldP


def _chunk_phi(cfg: TreeConfig, ens: Ensemble, st: _Statics, c0: int,
               c1: int, Xn: torch.Tensor, Xc: Optional[torch.Tensor],
               n_features: int, acc: torch.Tensor) -> None:
    """Adds the SHAP values of the ensemble's trees [c0, c1) to ``acc``
    [N, n_features * O]."""
    D = cfg.max_depth
    L = 1 << D
    P = L - 1
    N = Xn.shape[0]
    T = c1 - c0
    sl = slice(c0, c1)
    # follow-right indicator for every internal node (node.cpp:77-96); each
    # gather's index is clamped to its own block (a categorical node's
    # feature indexes the categorical block and may lie past the numeric
    # one, and the other way round); the unused value is discarded below
    f = ens.feat[sl, :P].long().clamp(min=0)                        # [T, P]
    n_num = Xn.shape[1]
    if n_num > 0:
        go = Xn[:, f.clamp(max=n_num - 1)] > ens.thr[sl, :P]      # [N, T, P]
    else:
        go = torch.zeros((N, T, P), dtype=torch.bool, device=Xn.device)
    if Xc is not None and Xc.shape[1] > 0:
        xc = Xc[:, f.clamp(max=Xc.shape[1] - 1)]
        go = torch.where(ens.is_numeric[sl, :P], go,
                         xc == ens.cat_code[sl, :P])
    hot = [(go[:, :, st.node[d]] == st.right[d]) | ~st.valid0[d][sl]
           for d in range(D)]                                      # [N, T, L]
    for i, j, dup in st.dups:
        dup = dup[sl]
        hot[i] = hot[i] & (hot[j] | ~dup)
        hot[j] = hot[j] | dup
    # (hot_j - cold_j) * valid_j; the follow-indicators are exact 0/1, so
    # the products below equal the JAX package's float ones
    diff = [(hot[j].float() - st.cold[j][sl]) * st.validf[j][sl]
            for j in range(D)]
    phi = torch.zeros((D, N, T, L), dtype=torch.float32, device=Xn.device)
    for t in range(1 << D):
        bits = [(t >> s) & 1 for s in range(D)]
        hotP = None
        for s in range(D):
            if bits[s]:
                hotP = hot[s] if hotP is None else hotP & hot[s]
        for j in range(D):
            if bits[j]:
                continue
            a = st.coef[(t, j)][sl]
            if hotP is not None:
                a = torch.where(hotP, a, 0.0)
            phi[j] += a * diff[j]
    # scatter slots -> features, weighted by the leaf values, one slot at a
    # time: M_j[t, l, f, o] = [slot(t, l, j) == f] * value[t, l, o]
    feats = torch.arange(n_features, device=Xn.device)
    lv = ens.leaf_values[sl][:, :, None, :]                       # [T, L, 1, O]
    for j in range(D):
        M = (st.slot[sl][:, :, j, None] == feats).float()[..., None] * lv
        acc.addmm_(phi[j].reshape(N, T * L), M.reshape(T * L, -1))


def tree_shap_device_one(cfg: TreeConfig, feat, thr, code, is_split,
                         is_numeric, counts, leaf_values, Xn: torch.Tensor,
                         Xc: Optional[torch.Tensor],
                         n_features: int) -> torch.Tensor:
    """SHAP values of one tree given by its heap arrays (``feat`` [NODES],
    ..., ``counts`` [2L-1], ``leaf_values`` [L, O]): [N, n_features,
    output_dim] on the tensors' device."""
    dev = Xn.device
    O = leaf_values.shape[-1]
    one = Ensemble(
        feat=feat[None], thr=thr[None], cat_code=code[None],
        is_split=is_split[None], is_numeric=is_numeric[None],
        leaf_values=leaf_values[None], counts=counts[None],
        depths=torch.zeros(1, dtype=torch.int32, device=dev),
        bias=torch.zeros(O, dtype=torch.float32, device=dev),
        n_trees=torch.ones((), dtype=torch.int32, device=dev))
    acc = torch.zeros((Xn.shape[0], n_features * O), dtype=torch.float32,
                      device=dev)
    _chunk_phi(cfg, one, _Statics(cfg, one, 1, Xn.shape[1]), 0, 1, Xn, Xc,
               n_features, acc)
    return acc.reshape(Xn.shape[0], n_features, O)


def ensemble_shap_device(cfg: TreeConfig, ens: Ensemble, Xn: torch.Tensor,
                         Xc: Optional[torch.Tensor], n_features: int,
                         tree_idx: Optional[int] = None) -> torch.Tensor:
    """Sum of per-tree SHAP over the live trees (or ONE tree if
    ``tree_idx`` is given): [N, n_features, output_dim] on the ensemble's
    device.  Trees at or past ``n_trees`` are never read."""
    N = Xn.shape[0]
    O = cfg.output_dim
    if tree_idx is not None:
        if not 0 <= tree_idx < ens.capacity:
            raise IndexError(f"tree_idx {tree_idx} out of range "
                             f"[0, {ens.capacity})")
        t = tree_idx
        return tree_shap_device_one(
            cfg, ens.feat[t], ens.thr[t], ens.cat_code[t], ens.is_split[t],
            ens.is_numeric[t], ens.counts[t], ens.leaf_values[t], Xn, Xc,
            n_features)
    n_trees = int(ens.n_trees)
    acc = torch.zeros((N, n_features * O), dtype=torch.float32,
                      device=Xn.device)
    if n_trees:
        st = _Statics(cfg, ens, n_trees, Xn.shape[1])
        T_c = chunk_trees(N, cfg.max_depth, n_trees, n_features, O)
        for c0 in range(0, n_trees, T_c):
            _chunk_phi(cfg, ens, st, c0, min(c0 + T_c, n_trees), Xn, Xc,
                       n_features, acc)
    return acc.reshape(N, n_features, O)
