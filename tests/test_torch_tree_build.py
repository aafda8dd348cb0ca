"""The port's whole-tree path (K6) against the JAX package on the CPU.

``build_tree`` with ``_DISABLE_FUSED_TREE = False`` runs ``tree_build_plain``
here (CPU tensors) and is held against the JAX package's ``build_tree`` with
its K6 (``tree_build_pallas``) in interpret mode, in the cases and
tolerances of ``tests/test_pallas_kernels.py``: feat and is_split equal,
thr close, leaves within atol 1e-5, counts and depth equal.  The K6 path is
also held against the port's own level path (K2 + K3) on the same inputs.
Inputs are made with numpy from fixed seeds."""
import contextlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gbrl_tpu.config import TreeConfig as JConfig
from gbrl_tpu.ops import candidates as jcand
from gbrl_tpu.ops import fit as jfit

from gbrl_tpu_torch.config import TreeConfig
from gbrl_tpu_torch.ops import fit as tfit
from gbrl_tpu_torch.ops import kernels as K


@contextlib.contextmanager
def k6_path():
    """Both packages' build_tree on their whole-tree path (the JAX one in
    interpret mode), restored afterwards."""
    jfit._FORCE_FUSED_INTERPRET = True
    jfit._DISABLE_FUSED_TREE = False
    tfit._DISABLE_FUSED_TREE = False
    try:
        yield
    finally:
        jfit._FORCE_FUSED_INTERPRET = False
        jfit._DISABLE_FUSED_TREE = True
        tfit._DISABLE_FUSED_TREE = True


def _trees(kw, X, g, w, fw, dupes=False):
    """(JAX K6 tree, port K6 tree, port level-path tree) as numpy dicts."""
    jcfg, tcfg = JConfig(**kw), TreeConfig(**kw)
    cand = np.asarray(jcand.numerical_candidates(jcfg, jnp.asarray(X))).copy()
    if dupes:
        cand[:, 3:6] = cand[:, 3:4]                  # duplicate grid entries
    Xb = np.asarray(jcand.bucketize(jnp.asarray(X), jnp.asarray(cand)))
    args = (Xb, cand, g, g, w, fw)
    jargs = [jnp.asarray(a) for a in args]
    targs = [torch.from_numpy(np.array(a)) for a in args]
    level = tfit.build_tree(tcfg, *targs)
    with k6_path():
        jt = jfit.build_tree(jcfg, *jargs)
        tt = tfit.build_tree(tcfg, *targs)
    return ({k: np.asarray(v) for k, v in jt.items()},
            {k: v.numpy() for k, v in tt.items()},
            {k: v.numpy() for k, v in level.items()})


def _assert_same_tree(got, want, leaf_atol=1e-5):
    np.testing.assert_array_equal(got["feat"], want["feat"])
    np.testing.assert_array_equal(got["is_split"], want["is_split"])
    np.testing.assert_allclose(got["thr"], want["thr"])
    np.testing.assert_allclose(got["leaf_values"], want["leaf_values"],
                               atol=leaf_atol)
    np.testing.assert_allclose(got["counts"], want["counts"])
    assert int(got["depth"]) == int(want["depth"])


@pytest.mark.parametrize("policy,score", [("greedy", "cosine"),
                                          ("greedy", "l2"),
                                          ("oblivious", "cosine"),
                                          ("oblivious", "l2")])
def test_k6_path_matches_jax_k6(policy, score):
    """The cases of test_fused_tree_kernel_matches_xla: N = 700 (not a
    multiple of the tile), F = 5, O = 3, 16 bins, depth 4."""
    rng = np.random.default_rng(21)
    N, F, O, B, D = 700, 5, 3, 16, 4
    kw = dict(input_dim=F, output_dim=O, n_num_features=F, max_depth=D,
              n_bins=B, grow_policy=policy, split_score_func=score,
              generator_type="quantile")
    X = rng.normal(size=(N, F)).astype(np.float32)
    g = rng.normal(size=(N, O)).astype(np.float32)
    jt, tt, level = _trees(kw, X, g, np.ones(N, np.float32),
                           np.ones(F, np.float32))
    _assert_same_tree(tt, jt)
    _assert_same_tree(tt, level)


@pytest.mark.parametrize("policy,min_data,depth", [("greedy", 20, 3),
                                                   ("oblivious", 20, 2),
                                                   ("greedy", 0, 1)])
def test_k6_path_min_data_and_weights(policy, min_data, depth):
    """min_data_in_leaf, masked sample weights, a zero and non-uniform
    feature weights and duplicate candidates (test_fused_tree_kernel_min_
    data_and_weights, widened to both grow policies and depths 1-3)."""
    rng = np.random.default_rng(22)
    N, F, O, B = 400, 4, 2, 8
    kw = dict(input_dim=F, output_dim=O, n_num_features=F, max_depth=depth,
              n_bins=B, grow_policy=policy, split_score_func="cosine",
              generator_type="uniform", min_data_in_leaf=min_data)
    X = rng.normal(size=(N, F)).astype(np.float32)
    g = rng.normal(size=(N, O)).astype(np.float32)
    w = (rng.random(N) > 0.2).astype(np.float32)
    fw = np.array([1.0, 0.1, 2.0, 0.0], dtype=np.float32)
    jt, tt, level = _trees(kw, X, g, w, fw, dupes=True)
    _assert_same_tree(tt, jt)
    _assert_same_tree(tt, level)


@pytest.mark.parametrize("N,policy", [(5, "greedy"), (100, "oblivious"),
                                      (513, "greedy")])
def test_k6_cluster_tiles_match_jax(N, policy):
    """tree_build_cuda on CPU tensors (tree_build_plain at the cluster
    plan's tile: one rank, two, eight with a ragged last tile) against the
    JAX K6 in interpret mode and the port's level path."""
    rng = np.random.default_rng(N)
    F, O, B = 3, 2, 8
    kw = dict(input_dim=F, output_dim=O, n_num_features=F, max_depth=3,
              n_bins=B, grow_policy=policy, split_score_func="l2",
              generator_type="quantile")
    X = rng.normal(size=(N, F)).astype(np.float32)
    g = rng.normal(size=(N, O)).astype(np.float32)
    w = (rng.random(N) > 0.1).astype(np.float32)
    jt, tt, level = _trees(kw, X, g, w, np.ones(F, np.float32))
    _assert_same_tree(tt, jt)
    _assert_same_tree(tt, level)


def test_tree_build_plain_order_and_outputs():
    """tree_build_cuda on CPU tensors is tree_build_plain at K6's tiling
    (one tile per rank of the cluster plan): two calls give the same bits;
    its leaf sums equal a per-tile sequential sum; levels past a node's 2^d
    slots stay zero."""
    rng = np.random.default_rng(5)
    N, F, O, B, D = 300, 3, 2, 8, 3
    Xb = torch.from_numpy(rng.integers(0, B + 1, (N, F)).astype(np.int32))
    cand = torch.from_numpy(np.sort(rng.normal(size=(F, B)), 1)
                            .astype(np.float32))
    g = torch.from_numpy(rng.normal(size=(N, O + 1)).astype(np.float32))
    g[:, O] = 1.0
    g[::7] = 0.0                                    # masked rows
    fw = torch.ones(F)
    a = (Xb, cand, fw, g, g, D, B, O, "l2", 0, False)
    first = K.tree_build_cuda(*a)
    again = K.tree_build_cuda(*a)
    for x, y in zip(first, again):
        assert torch.equal(x, y)
    best_idx, do_split, stats, leaf = first
    assert best_idx.shape == (D, K.NPMAX) and leaf.shape == (1 << D, O + 1)
    for d in range(D):
        assert not do_split[d, 1 << d:].any()
        assert not stats[d, 1 << d:].any()
    assert leaf[:, O].sum().item() == float((g[:, O] > 0).sum())
    tile, n_tiles = K._tree_tiling(N, F)
    assert n_tiles * tile >= N > (n_tiles - 1) * tile
    assert n_tiles <= K._tree_cluster(N) == K._tree_plan(
        N, F, O, B, D, False).S
    # leaf sums: sequential per tile, then over the tiles in order
    rel = np.zeros(N, np.int64)
    bi, sp = best_idx.numpy(), do_split.numpy()
    for d in range(D):
        f, b = bi[d, rel] // B, bi[d, rel] % B
        rel = 2 * rel + (sp[d, rel] & (Xb.numpy()[np.arange(N), f] > b))
    want = np.zeros((1 << D, O + 1), np.float32)
    for t in range(n_tiles):
        part = np.zeros_like(want)
        for n in range(t * tile, min(N, (t + 1) * tile)):
            part[rel[n]] = part[rel[n]] + g[n].numpy()
        want = want + part
    np.testing.assert_array_equal(leaf.numpy(), want)


def test_tree_build_rejects_depth_past_npmax():
    """Depth 5 has 16 nodes on its last split level, past K6's NPMAX = 8:
    build_tree keeps such trees on the level path."""
    rng = np.random.default_rng(3)
    N, F, O, B = 200, 3, 2, 8
    cfg = TreeConfig(input_dim=F, output_dim=O, n_num_features=F,
                     max_depth=5, n_bins=B)
    X = torch.from_numpy(rng.normal(size=(N, F)).astype(np.float32))
    g = torch.from_numpy(rng.normal(size=(N, O)).astype(np.float32))
    from gbrl_tpu_torch.ops.candidates import bucketize, numerical_candidates
    cand = numerical_candidates(cfg, X)
    Xb = bucketize(X, cand)
    level = tfit.build_tree(cfg, Xb, cand, g, g, torch.ones(N), torch.ones(F))
    tfit._DISABLE_FUSED_TREE = False
    try:
        same = tfit.build_tree(cfg, Xb, cand, g, g, torch.ones(N),
                               torch.ones(F))
    finally:
        tfit._DISABLE_FUSED_TREE = True
    for k in level:
        assert torch.equal(level[k], same[k]), k
