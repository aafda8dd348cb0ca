"""The plain reference against a naive oracle at tiny shapes: one node at a
time, one candidate at a time, Python loops."""
import numpy as np
import pytest
import torch

from bench_port.reference import trees


def naive_candidates(X, n_bins):
    n = len(X)
    counts = [n // (n_bins + 1) + (1 if i < n % (n_bins + 1) else 0)
              for i in range(n_bins + 1)]
    out = []
    for f in range(X.shape[1]):
        col = sorted(X[:, f])
        cum = 0
        row = []
        for b in range(n_bins):
            cum += counts[b]
            row.append(col[min(cum - 1, n - 1)])
        out.append(row)
    return np.array(out, np.float32)


def naive_score(g, idx_left, idx_right):
    s = 0.0
    for idx in (idx_left, idx_right):
        if len(idx):
            tot = g[idx].sum(axis=0)
            s += float(tot @ tot) / len(idx)
    return np.sqrt(s) if s > 0 else 0.0


def naive_tree(X, g, depth, n_bins, oblivious):
    """Heap arrays of one cosine tree, every row weighted 1."""
    cand = naive_candidates(X, n_bins)
    F, B = cand.shape
    nodes = {0: (list(range(len(X))), [])}
    n_int = 2 ** depth - 1
    feat = -np.ones(n_int, int)
    thr = np.zeros(n_int, np.float32)
    split = np.zeros(n_int, bool)
    for d in range(depth):
        level = list(range(2 ** d - 1, 2 ** (d + 1) - 1))

        def score(p, f, b):
            idx, path = nodes[p]
            if (f, cand[f, b]) in path:
                return -np.inf
            left = [i for i in idx if not X[i, f] > cand[f, b]]
            right = [i for i in idx if X[i, f] > cand[f, b]]
            return naive_score(g, left, right)
        choice = {}
        if oblivious:
            tot = [[sum(score(p, f, b) for p in level) for b in range(B)]
                   for f in range(F)]
            best = max(max(r) for r in tot)
            f, b = next((f, b) for f in range(F) for b in range(B)
                        if tot[f][b] >= best - abs(best) * trees.TIE_RTOL)
            for p in level:
                choice[p] = (f, b, best > -np.inf)
        else:
            for p in level:
                idx, _ = nodes[p]
                parent = naive_score(g, idx, []) if d > 0 else 0.0
                sc = [[score(p, f, b) - parent for b in range(B)]
                      for f in range(F)]
                best = max(max(r) for r in sc)
                tol = (abs(best) + abs(parent)) * trees.TIE_RTOL
                f, b = next((f, b) for f in range(F) for b in range(B)
                            if sc[f][b] >= best - tol)
                choice[p] = (f, b, best >= 0 and len(idx) > 0)
        for p in level:
            f, b, ok = choice[p]
            idx, path = nodes[p]
            if ok:
                feat[p], thr[p], split[p] = f, cand[f, b], True
                right = [i for i in idx if X[i, f] > cand[f, b]]
                left = [i for i in idx if not X[i, f] > cand[f, b]]
                path = path + [(f, cand[f, b])]
            else:
                left, right = idx, []
            nodes[2 * p + 1] = (left, path)
            nodes[2 * p + 2] = (right, path)
    leaves = np.zeros((2 ** depth, g.shape[1]))
    for j in range(2 ** depth):
        idx, _ = nodes[n_int + j]
        if idx:
            leaves[j] = g[idx].mean(axis=0)
    return feat, thr, split, leaves


@pytest.mark.parametrize("oblivious", [False, True])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_fit_tree_against_naive(oblivious, seed):
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(14, 2)).astype(np.float32)
    X[3, 0] = X[5, 0]                        # a duplicate candidate value
    g = rng.normal(size=(14, 2))
    want = naive_tree(X, g, 3, 4, oblivious)
    got = trees.fit_tree(torch.from_numpy(X), torch.from_numpy(g),
                         torch.ones(14, dtype=torch.float64),
                         torch.ones(2, dtype=torch.float64), 3, 4, "cosine",
                         oblivious)
    np.testing.assert_array_equal(got["feat"].numpy(), want[0])
    np.testing.assert_array_equal(got["thr"].numpy(), want[1])
    np.testing.assert_array_equal(got["is_split"].numpy(), want[2])
    np.testing.assert_allclose(got["leaf_values"].numpy(), want[3],
                               rtol=1e-12, atol=1e-12)


def test_ensemble_sum_against_naive():
    rng = np.random.default_rng(3)
    T, D, F, O, N = 5, 3, 3, 2, 7
    feat = rng.integers(-1, F, (T, 2 ** D - 1))
    thr = rng.normal(size=(T, 2 ** D - 1)).astype(np.float32)
    split = feat >= 0
    leaves = rng.normal(size=(T, 2 ** D, O))
    coeff = rng.normal(size=(T, O))
    X = rng.normal(size=(N, F)).astype(np.float32)
    want = np.zeros((N, O))
    for n in range(N):
        for t in range(T):
            p = 0
            for _ in range(D):
                go = split[t, p] and X[n, max(feat[t, p], 0)] > thr[t, p]
                p = 2 * p + 1 + int(go)
            want[n] += coeff[t] * leaves[t, p - (2 ** D - 1)]
    got = trees.ensemble_sum(torch.from_numpy(X), torch.from_numpy(feat),
                             torch.from_numpy(thr), torch.from_numpy(split),
                             torch.from_numpy(leaves), torch.from_numpy(coeff),
                             D, chunk=2)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-12, atol=1e-12)


def test_quantile_candidates():
    X = np.random.default_rng(4).normal(size=(11, 3)).astype(np.float32)
    np.testing.assert_array_equal(
        trees.quantile_candidates(torch.from_numpy(X), 4).numpy(),
        naive_candidates(X, 4))


def _flip(tree: dict, node: int, cand_value: float, feature: int) -> dict:
    out = {k: v.clone().numpy() for k, v in tree.items()
           if k != "leaf_values"}
    if out["is_split"][node]:
        out["is_split"][node], out["feat"][node], out["thr"][node] = (
            False, -1, 0.0)
    else:
        out["is_split"][node], out["feat"][node], out["thr"][node] = (
            True, feature, cand_value)
    return out


def test_zero_gain_node_follows_the_program():
    """One row of weight: below the root every split moves rows of no
    weight only, a gain of zero; the reference takes the program's split
    or its absence there."""
    rng = np.random.default_rng(5)
    X = torch.from_numpy(rng.normal(size=(10, 2)).astype(np.float32))
    g = torch.from_numpy(rng.normal(size=(10, 1)))
    w = torch.zeros(10, dtype=torch.float64)
    w[0] = 1.0
    fw = torch.ones(2, dtype=torch.float64)
    own = trees.fit_tree(X, g, w, fw, 2, 4, "cosine", False)
    # the child of the root that holds the row of weight
    node = 2 if float(X[0, own["feat"][0]]) > float(own["thr"][0]) else 1
    cand = trees.quantile_candidates(X, 4)
    follow = _flip(own, node, float(cand[1, 0]), 1)
    got = trees.fit_tree(X, g, w, fw, 2, 4, "cosine", False, follow=follow)
    assert bool(got["is_split"][node]) == bool(follow["is_split"][node])
    assert int(got["feat"][node]) == int(follow["feat"][node])


def test_a_worse_split_is_not_followed():
    rng = np.random.default_rng(6)
    X = torch.from_numpy(rng.normal(size=(40, 2)).astype(np.float32))
    g = torch.from_numpy(rng.normal(size=(40, 1)))
    w = torch.ones(40, dtype=torch.float64)
    fw = torch.ones(2, dtype=torch.float64)
    for oblivious in (False, True):
        own = trees.fit_tree(X, g, w, fw, 2, 8, "cosine", oblivious)
        cand = trees.quantile_candidates(X, 8)
        follow = {k: v.clone().numpy() for k, v in own.items()
                  if k != "leaf_values"}
        f = 1 - int(own["feat"][0])
        follow["feat"][0], follow["thr"][0] = f, float(cand[f, 0])
        got = trees.fit_tree(X, g, w, fw, 2, 8, "cosine", oblivious,
                             follow=follow)
        assert int(got["feat"][0]) == int(own["feat"][0])
        assert float(got["thr"][0]) == float(own["thr"][0])
