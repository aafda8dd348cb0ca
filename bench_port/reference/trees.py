"""Plain PyTorch reference of one boosted tree and of an ensemble walk.

Written from the algorithm of NVlabs/gbrl's C++ fitter (fitter.cpp,
node.cpp, split_candidate_generator.cpp), as the port documents it, and
independent of the port's code:

- quantile candidates: ``n_bins + 1`` equal-count bins over each feature's
  sorted values, the remainder one each to the first bins; candidate b is
  the sorted value at the bin's cumulative count - 1;
- a sample goes right when ``x > threshold``;
- score of a split from the children's gradient sums S and (weighted)
  counts n: ``||S_L||^2 / n_L + ||S_R||^2 / n_R`` (a side with n = 0 gives
  0), its square root for the cosine score; a candidate already used on
  the node's path (same feature and value) is blocked; times the feature's
  weight;
- greedy growth: each node takes its best candidate minus the node's own
  score (none at the root) and splits when that is >= 0 and it holds
  samples; oblivious growth: one candidate per level, best by the sum over
  the level's nodes, while that sum is finite;
- argmax: the first index among the scores within 2e-6 relative of the
  largest (greedy below the root: of the largest plus the node's score),
  the tie rule the port states for its float32 sums;
- leaf value: the weighted mean of the raw gradients of its samples;
- ties: where a program's tree is given (``follow``), a node takes the
  program's choice wherever the rule allows it, that is, where its
  candidate scores within the tie band of the best, or where the best
  gain is zero to within the band and the program did not split (a split
  of zero gain moves only rows of no weight; float32 and float64 round it
  to either side of 0).  Any other choice stays the reference's own, and
  the gaps show it.

Trees are perfect binary heaps (children 2p + 1 and 2p + 2); a node that
does not split sends its samples left.  Every sum is taken in ``dtype``
(float64 for the reference, a lower precision for the control); the
features and thresholds stay float32, as the port's inputs are.
"""
from __future__ import annotations

import numpy as np
import torch

TIE_RTOL = 2e-6
NEG_INF = float("-inf")


def quantile_candidates(X: torch.Tensor, n_bins: int) -> torch.Tensor:
    """[N, F] -> [F, n_bins] thresholds, ascending per feature."""
    n = X.shape[0]
    counts = torch.full((n_bins + 1,), n // (n_bins + 1), dtype=torch.int64)
    counts[: n % (n_bins + 1)] += 1
    idx = torch.clamp(torch.cumsum(counts, 0)[:n_bins] - 1, 0, n - 1)
    Xs = torch.sort(X, dim=0, stable=True).values
    return Xs[idx.to(X.device)].T.contiguous()


def _l2(s: torch.Tensor, n: torch.Tensor) -> torch.Tensor:
    sq = torch.sum(s * s, dim=-1)
    return torch.where(n > 0, sq / torch.where(n > 0, n, torch.ones_like(n)),
                       torch.zeros_like(sq))


def _score(sl, nl, sr, nr, score: str) -> torch.Tensor:
    s = _l2(sl, nl) + _l2(sr, nr)
    if score == "cosine":
        s = torch.where(s > 0, torch.sqrt(torch.clamp(s, min=0)),
                        torch.zeros_like(s))
    return s


def _first_argmax(x: torch.Tensor, scale=None) -> torch.Tensor:
    """First index within the tie band of the row's max (last dim)."""
    m = torch.amax(x, dim=-1, keepdim=True)
    base = m.abs() if scale is None else m.abs() + scale
    tol = torch.where(torch.isfinite(m), base * TIE_RTOL, torch.zeros_like(m))
    return torch.argmax((x >= m - tol).to(torch.uint8), dim=-1)


def _followed(follow: dict, lo: int, nn: int, cand: torch.Tensor):
    """The program's choices at the nodes lo .. lo + nn - 1 as candidate
    indices: (index [nn], is a candidate [nn], splits [nn])."""
    dev = cand.device
    B = cand.shape[1]
    f = torch.as_tensor(follow["feat"][lo:lo + nn], device=dev).long()
    t = torch.as_tensor(follow["thr"][lo:lo + nn], device=dev)
    s = torch.as_tensor(follow["is_split"][lo:lo + nn], device=dev).bool()
    fc = torch.clamp(f, min=0)
    match = cand[fc] == t.to(cand.dtype)[:, None]               # [nn, B]
    idx = fc * B + torch.argmax(match.to(torch.uint8), dim=1)
    return idx, match.any(dim=1) & (f >= 0), s


def fit_tree(X: torch.Tensor, grads: torch.Tensor, w: torch.Tensor,
             feat_w: torch.Tensor, depth: int, n_bins: int, score: str,
             oblivious: bool, dtype=torch.float64,
             follow: dict = None) -> dict:
    """One tree on rows X [N, F] (float32) with gradients [N, O] and 0/1
    row weights [N].  Returns heap arrays: feat [2^D - 1] (-1 unsplit),
    thr, is_split, leaf_values [2^D, O] (in ``dtype``).  ``follow``, a
    program's tree (heap arrays), settles the ties."""
    N, F = X.shape
    O = grads.shape[1]
    dev = X.device
    g = grads.to(dtype) * w.to(dtype)[:, None]
    cnt = w.to(dtype)
    fw = feat_w.to(dtype)
    cand = quantile_candidates(X, n_bins)                       # [F, B]
    B = cand.shape[1]
    left = (X[:, :, None] <= cand[None]).reshape(N, F * B).to(dtype)
    rows = torch.cat([g, cnt[:, None]], dim=1)                  # [N, O + 1]
    node = torch.zeros(N, dtype=torch.int64, device=dev)
    blocked = torch.zeros((1, F, B), dtype=torch.bool, device=dev)
    n_int = (1 << depth) - 1
    feat = torch.full((n_int,), -1, dtype=torch.int64, device=dev)
    thr = torch.zeros((n_int,), dtype=torch.float32, device=dev)
    split = torch.zeros((n_int,), dtype=torch.bool, device=dev)
    alive = True
    for d in range(depth):
        nn = 1 << d
        oh = (node[:, None] == torch.arange(nn, device=dev)[None]).to(dtype)
        tot = oh.T @ rows                                       # [nn, O + 1]
        per = (oh[:, :, None] * rows[:, None, :]).reshape(N, nn * (O + 1))
        lsum = (per.T @ left).reshape(nn, O + 1, F, B).permute(0, 2, 3, 1)
        sl, nl = lsum[..., :O], lsum[..., O]
        sr = tot[:, None, None, :O] - sl
        nr = tot[:, None, None, O] - nl
        sc = _score(sl, nl, sr, nr, score)                      # [nn, F, B]
        sc = torch.where(blocked, torch.full_like(sc, NEG_INF), sc)
        sc = (sc * fw[None, :, None]).reshape(nn, F * B)
        sc = torch.where(torch.isnan(sc), torch.full_like(sc, NEG_INF), sc)
        if oblivious:
            total = torch.sum(sc, dim=0)
            total = torch.where(torch.isnan(total),
                                torch.full_like(total, NEG_INF), total)
            j = _first_argmax(total)
            if follow is not None:
                fj, ok, fs = _followed(follow, (1 << d) - 1, 1, cand)
                m = total[j]
                if bool(fs[0] & ok[0]) and bool(
                        total[fj[0]] >= m - m.abs() * TIE_RTOL):
                    j = fj[0]
            alive = alive and bool(total[j] > NEG_INF)
            best_idx = j.expand(nn)
            do_split = torch.full((nn,), alive, dtype=torch.bool, device=dev)
        else:
            scale = None
            if d > 0:
                parent = _score(tot[:, :O], tot[:, O],
                                torch.zeros_like(tot[:, :O]),
                                torch.zeros_like(tot[:, O]), score)
                sc = sc - parent[:, None]
                scale = parent.abs()[:, None]
            best_idx = _first_argmax(sc, scale)
            best = torch.gather(sc, 1, best_idx[:, None])[:, 0]
            do_split = (best >= 0) & (tot[:, O] > 0)
            if follow is not None:
                fj, ok, fs = _followed(follow, (1 << d) - 1, nn, cand)
                tol = (best.abs() + (0 if scale is None else scale[:, 0])
                       ) * TIE_RTOL
                got = torch.gather(sc, 1, fj[:, None])[:, 0]
                take = fs & ok & (got >= best - tol) & (got >= -tol) & (
                    tot[:, O] > 0)
                stay = ~fs & (best <= tol)
                best_idx = torch.where(take, fj, best_idx)
                do_split = torch.where(take | stay, fs, do_split)
        f_sel = best_idx // B
        v_sel = cand[f_sel, best_idx % B]
        lo = (1 << d) - 1
        feat[lo:lo + nn] = torch.where(do_split, f_sel, -1)
        thr[lo:lo + nn] = torch.where(do_split, v_sel, torch.zeros_like(v_sel))
        split[lo:lo + nn] = do_split
        x = torch.gather(X, 1, f_sel[node][:, None])[:, 0]
        go = (x > v_sel[node]) & do_split[node]
        node = node * 2 + go.to(torch.int64)
        chosen = (do_split[:, None, None]
                  & (f_sel[:, None, None]
                     == torch.arange(F, device=dev)[None, :, None])
                  & (v_sel[:, None, None] == cand[None]))
        rep = torch.arange(2 * nn, device=dev) // 2
        blocked = (blocked | chosen)[rep]
    L = 1 << depth
    oh = (node[:, None] == torch.arange(L, device=dev)[None]).to(dtype)
    leaf = oh.T @ rows
    n_leaf = leaf[:, O]
    values = torch.where(n_leaf[:, None] > 0,
                         leaf[:, :O] / torch.where(n_leaf > 0, n_leaf,
                                                   torch.ones_like(n_leaf)
                                                   )[:, None],
                         torch.zeros_like(leaf[:, :O]))
    return dict(feat=feat, thr=thr, is_split=split, leaf_values=values)


def leaf_index(X: torch.Tensor, feat: torch.Tensor, thr: torch.Tensor,
               is_split: torch.Tensor, depth: int) -> torch.Tensor:
    """Heap walk of T trees: X [N, F], feat / thr / is_split [T, 2^D - 1]
    -> [N, T] leaf indices."""
    N = X.shape[0]
    T, n_int = feat.shape
    base = (torch.arange(T, device=X.device) * n_int)[None, :]
    ft = feat.reshape(-1).to(torch.int64)
    th = thr.reshape(-1)
    sp = is_split.reshape(-1)
    p = torch.zeros((N, T), dtype=torch.int64, device=X.device)
    for _ in range(depth):
        idx = base + p
        f = torch.clamp(ft[idx], min=0)
        go = sp[idx] & (torch.gather(X, 1, f) > th[idx])
        p = 2 * p + 1 + go.to(torch.int64)
    return p - n_int


def tree_values(X: torch.Tensor, tree: dict, depth: int) -> torch.Tensor:
    """One tree's leaf values for every row: [N, O]."""
    leaf = leaf_index(X, tree["feat"][None], tree["thr"][None],
                      tree["is_split"][None], depth)[:, 0]
    return tree["leaf_values"][leaf]


def ensemble_sum(X: torch.Tensor, feat, thr, is_split, leaf_values,
                 coeff: torch.Tensor, depth: int, dtype=torch.float64,
                 chunk: int = 256) -> torch.Tensor:
    """sum_t coeff[t, :] * leaf_values[t, leaf(x, t), :] -> [N, O], the
    trees taken in chunks so that [N, chunk] indices fit; the products and
    the sum in ``dtype``."""
    T = feat.shape[0]
    O = leaf_values.shape[-1]
    acc = torch.zeros((X.shape[0], O), dtype=dtype, device=X.device)
    for t0 in range(0, T, chunk):
        t1 = min(T, t0 + chunk)
        leaf = leaf_index(X, feat[t0:t1], thr[t0:t1], is_split[t0:t1], depth)
        w = leaf_values[t0:t1].to(dtype) * coeff[t0:t1, None, :].to(dtype)
        trees = torch.arange(t1 - t0, device=X.device)[None, :]
        vals = w[trees, leaf]                                   # [N, C, O]
        if dtype == torch.float64:
            acc = acc + vals.sum(dim=1)
        else:
            # the control: one rounding per added tree, as a kernel that
            # accumulates in the lower precision
            for c in range(t1 - t0):
                acc = acc + vals[:, c]
    return acc


def predict(obs, ens: dict, coeff_row, depth: int, dtype=torch.float64,
            device="cpu") -> torch.Tensor:
    """``ens["bias"]`` plus every tree of ``ens`` (host heap arrays [T,
    ...]) times the columns' coefficients ``coeff_row`` [O]: [N, O]."""
    X = torch.as_tensor(obs, device=device)
    T = ens["feat"].shape[0]
    coeff = torch.as_tensor(np.asarray(coeff_row, np.float64),
                            device=device).to(dtype)[None, :].expand(T, -1)
    dev = {k: torch.as_tensor(ens[k], device=device)
           for k in ("feat", "thr", "is_split", "leaf_values")}
    bias = torch.as_tensor(np.asarray(ens["bias"], np.float64),
                           device=device).to(dtype)
    return bias[None, :] + ensemble_sum(X, dev["feat"], dev["thr"],
                                        dev["is_split"], dev["leaf_values"],
                                        coeff, depth, dtype)


def stack(fitted: list, bias) -> dict:
    """Fitted trees as host heap arrays [T, ...] with a bias, the form
    ``predict`` reads."""
    out = {k: torch.stack([t[k] for t in fitted]).cpu().numpy()
           for k in ("feat", "thr", "is_split")}
    out["leaf_values"] = torch.stack([t["leaf_values"] for t in fitted]) \
        .to(torch.float64).cpu().numpy()
    out["bias"] = np.asarray(bias, np.float64)
    return out


def unstack(fitted: list) -> list:
    """Fitted trees' split arrays on the host, the form ``follow`` reads."""
    return [{k: t[k].cpu().numpy() for k in ("feat", "thr", "is_split")}
            for t in fitted]
