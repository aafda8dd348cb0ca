"""gbrl_tpu_torch.ops.predict / ops.kernels (plain versions, CPU) against
the JAX package's ops.predict (XLA path, and Pallas in interpret mode).

Inputs are made with numpy from seeds and handed to both packages.
Tolerance: rtol = atol = 2e-5, as the JAX package's own Pallas-vs-XLA
predict test; sums run in another order in the two packages."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gbrl_tpu.config import TreeConfig as JTreeConfig
from gbrl_tpu.config import tree_config_from_dicts as j_cfg_from_dicts
from gbrl_tpu.ensemble import ensemble_to_numpy as j_to_numpy
from gbrl_tpu.ensemble import init_ensemble as j_init_ensemble
from gbrl_tpu.ops import predict as jpred
from gbrl_tpu.ops.boosting import boost_step
from gbrl_tpu.optimizers import OptimizerSpec as JSpec
from gbrl_tpu.optimizers import sgd_coeff as j_sgd_coeff

from gbrl_tpu_torch.config import TreeConfig
from gbrl_tpu_torch.ensemble import ensemble_from_numpy
from gbrl_tpu_torch.ops import kernels as K
from gbrl_tpu_torch.ops import predict as tpred

TOL = dict(rtol=2e-5, atol=2e-5)


def _t(a):
    return torch.from_numpy(np.array(a))


def _port(ens_j):
    return ensemble_from_numpy(j_to_numpy(ens_j), device="cpu")


def _random_ensemble(rng, f, o, depth, t_cap, cat=False):
    """The random ensembles of tests/test_pallas_kernels.py (random feat in
    [-1, F), split mask, leaf values) plus, with ``cat``, categorical
    nodes."""
    cfg = JTreeConfig(input_dim=f, output_dim=o, n_num_features=f,
                      max_depth=depth)
    L, IN = 1 << depth, (1 << depth) - 1
    cap = 1 << (t_cap - 1).bit_length()
    ens = j_init_ensemble(cfg, capacity=cap)
    ens = ens.replace(
        feat=jnp.asarray(rng.integers(-1, f, size=(cap, IN)).astype(np.int32)),
        thr=jnp.asarray(rng.normal(size=(cap, IN)).astype(np.float32)),
        is_split=jnp.asarray(rng.random((cap, IN)) > 0.3),
        leaf_values=jnp.asarray(rng.normal(size=(cap, L, o)).astype(np.float32)),
        n_trees=jnp.asarray(t_cap, dtype=jnp.int32))
    if cat:
        ens = ens.replace(
            is_numeric=jnp.asarray(rng.random((cap, IN)) > 0.5),
            cat_code=jnp.asarray(rng.integers(-1, 4, size=(cap, IN))
                                 .astype(np.int32)))
    return cfg, ens, cap


def _port_cfg(cfg_j):
    return TreeConfig(**{f: getattr(cfg_j, f)
                         for f in cfg_j.__dataclass_fields__})


@pytest.mark.parametrize("n,f,o,depth,t_cap", [(300, 5, 3, 3, 7),
                                               (1000, 16, 2, 4, 130),
                                               (150, 300, 2, 7, 20)])
def test_weighted_leaf_sum_random_matches_xla(n, f, o, depth, t_cap):
    rng = np.random.default_rng(2)
    cfg_j, ens_j, cap = _random_ensemble(rng, f, o, depth, t_cap)
    X = rng.normal(size=(n, f)).astype(np.float32)
    coeff = (rng.normal(size=(cap, o))
             * (np.arange(cap) < t_cap)[:, None]).astype(np.float32)
    want = jpred.weighted_leaf_sum(cfg_j, ens_j, jnp.asarray(X),
                                   jnp.asarray(coeff))
    got = tpred.weighted_leaf_sum(_port_cfg(cfg_j), _port(ens_j), _t(X),
                                  _t(coeff))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def _oblivious(ens):
    """``ens`` (port) with one (feat, thr, is_split) per level."""
    feat, thr, spl = ens.feat.clone(), ens.thr.clone(), ens.is_split.clone()
    depth = (feat.shape[1] + 1).bit_length() - 1
    for d in range(depth):
        lo, k = (1 << d) - 1, 1 << d
        for a in (feat, thr, spl):
            a[:, lo:lo + k] = a[:, lo:lo + 1]
    return ens.replace(feat=feat, thr=thr, is_split=spl)


@pytest.mark.parametrize("policy", ["greedy", "oblivious"])
@pytest.mark.parametrize("f,depth", [(300, 4), (8, 8), (0, 3)])
def test_numeric_dispatch_reaches_kernel_wrapper(monkeypatch, policy, f,
                                                 depth):
    """With no categorical columns every shape goes to the K4/K5 wrapper
    (no feature or depth guard), and agrees with the heap walk."""
    rng = np.random.default_rng(8)
    n, o, t_cap = 64, 2, 12
    cfg_j, ens_j, cap = _random_ensemble(rng, max(f, 1), o, depth, t_cap)
    cfg = _port_cfg(cfg_j).replace(grow_policy=policy, input_dim=f,
                                   n_num_features=f)
    ens = _port(ens_j)
    if policy == "oblivious":
        ens = _oblivious(ens)
    X = _t(rng.normal(size=(n, f)).astype(np.float32))
    coeff = _t((rng.normal(size=(cap, o))
                * (np.arange(cap) < t_cap)[:, None]).astype(np.float32))
    name = ("oblivious_leaf_sum_cuda" if policy == "oblivious"
            else "weighted_leaf_sum_cuda")
    calls = []

    def spy(*args):
        calls.append(args[0].shape)
        return getattr(K, name)(*args)
    monkeypatch.setattr(tpred, name, spy)
    got = tpred.weighted_leaf_sum(cfg, ens, X, coeff)
    assert calls == [(n, max(f, 1))]
    want = (tpred.gather_leaf_values(cfg, ens, X) * coeff[None]).sum(dim=1)
    np.testing.assert_allclose(got.numpy(), want.numpy(), **TOL)


def test_k4_plain_matches_pallas_interpret():
    from gbrl_tpu.ops.pallas_kernels import weighted_leaf_sum_pallas
    rng = np.random.default_rng(4)
    n, f, o, depth, t_cap = 200, 6, 3, 3, 9
    cfg_j, ens_j, cap = _random_ensemble(rng, f, o, depth, t_cap)
    X = rng.normal(size=(n, f)).astype(np.float32)
    coeff = (rng.normal(size=(cap, o))
             * (np.arange(cap) < t_cap)[:, None]).astype(np.float32)
    w = np.asarray(ens_j.leaf_values) * coeff[:, None, :]
    want = weighted_leaf_sum_pallas(jnp.asarray(X), ens_j.feat, ens_j.thr,
                                    ens_j.is_split, jnp.asarray(w), depth,
                                    interpret=True, n_trees=ens_j.n_trees)
    ens = _port(ens_j)
    got = K.weighted_leaf_sum_cuda(_t(X), ens.feat, ens.thr, ens.is_split,
                                   _t(w), depth, ens.n_trees)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def _tables(rng, n, f, o, depth, cap, oblivious):
    """Random node tables (pass-through nodes included; one (feat, thr,
    is_split) per level when ``oblivious``), leaf values, coefficients and
    X with x == thr ties and a NaN row, as numpy arrays."""
    IN, L = (1 << depth) - 1, 1 << depth
    feat = rng.integers(-1, f, (cap, IN)).astype(np.int32)
    thr = rng.normal(size=(cap, IN)).astype(np.float32)
    spl = rng.random((cap, IN)) > 0.3
    if oblivious:
        for d in range(depth):
            lo, k = (1 << d) - 1, 1 << d
            for a in (feat, thr, spl):
                a[:, lo:lo + k] = a[:, lo:lo + 1]
    lv = rng.normal(size=(cap, L, o)).astype(np.float32)
    coeff = rng.normal(size=(cap, o)).astype(np.float32)
    X = rng.normal(size=(n, f)).astype(np.float32)
    X[: n // 4, max(feat[0, 0], 0)] = thr[0, 0]
    X[-1] = np.nan
    return X, feat, thr, spl, lv, coeff


@pytest.mark.parametrize("oblivious", [False, True])
@pytest.mark.parametrize("n,f,o,depth,cap,nt", [(200, 6, 3, 3, 16, 9),
                                                (64, 5, 11, 4, 8, 8),
                                                (40, 16, 3, 11, 4, 3)])
def test_plain_coeff_equals_prescaled_bits(oblivious, n, f, o, depth, cap,
                                           nt):
    """The plain K4 / K5 given the leaf values and a separate ``coeff``
    give the same bits as given ``leaf_values * coeff[:, None, :]`` (the
    product ops/predict.py built before), also through the wrappers on CPU
    tensors; on an oblivious ensemble K5's bits equal K4's."""
    rng = np.random.default_rng(n + o + depth)
    X, feat, thr, spl, lv, coeff = (_t(a) for a in _tables(
        rng, n, f, o, depth, cap, oblivious))
    w = lv * coeff[:, None, :]
    fns = [(K.weighted_leaf_sum_plain, K.weighted_leaf_sum_cuda)]
    if oblivious:
        fns.append((K.oblivious_leaf_sum_plain, K.oblivious_leaf_sum_cuda))
    outs = []
    for plain, wrapper in fns:
        want = plain(X, feat, thr, spl, w, depth, nt)
        got = plain(X, feat, thr, spl, lv, depth, nt, coeff)
        assert torch.equal(got, want)
        ntd = torch.tensor(nt, dtype=torch.int32)
        assert torch.equal(wrapper(X, feat, thr, spl, lv, depth, ntd, coeff),
                           want)
        outs.append(got)
    assert all(torch.equal(a, outs[0]) for a in outs[1:])


@pytest.mark.parametrize("oblivious", [False, True])
@pytest.mark.parametrize("n,f,o,depth,cap,nt", [(200, 6, 3, 3, 16, 9),
                                                (64, 5, 11, 3, 8, 6)])
def test_plain_coeff_matches_pallas_interpret(oblivious, n, f, o, depth, cap,
                                              nt):
    """The plain K4 (and, on an oblivious ensemble, K5) with a separate
    ``coeff`` against the JAX Pallas kernels in interpret mode given the
    pre-scaled weights, at a small size and at O = 11."""
    from gbrl_tpu.ops.pallas_kernels import (oblivious_leaf_sum_pallas,
                                             weighted_leaf_sum_pallas)
    rng = np.random.default_rng(n * o + depth)
    X, feat, thr, spl, lv, coeff = _tables(rng, n, f, o, depth, cap,
                                           oblivious)
    X[-1] = 0.5                  # the Pallas kernels' one-hot select of NaN
    coeff[nt:] = 0.0             # as every caller: zero past n_trees
    spl &= feat >= 0             # as fitted trees: feat -1 only unsplit
    w = lv * coeff[:, None, :]
    pairs = [(weighted_leaf_sum_pallas, K.weighted_leaf_sum_plain)]
    if oblivious:
        pairs.append((oblivious_leaf_sum_pallas, K.oblivious_leaf_sum_plain))
    for pallas, plain in pairs:
        want = pallas(jnp.asarray(X), jnp.asarray(feat), jnp.asarray(thr),
                      jnp.asarray(spl), jnp.asarray(w), depth,
                      interpret=True, n_trees=jnp.asarray(nt, jnp.int32))
        got = plain(*(_t(a) for a in (X, feat, thr, spl, lv)), depth, nt,
                    _t(coeff))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_depth_11_matches_xla():
    """Depth 11 at F = 16, O = 3 (past the old shared-memory ceiling):
    ``ops.predict.weighted_leaf_sum`` against the JAX package's XLA walk on
    the same ensemble and coefficients."""
    rng = np.random.default_rng(11)
    n, f, o, depth, t_cap = 64, 16, 3, 11, 3
    cfg_j, ens_j, cap = _random_ensemble(rng, f, o, depth, t_cap)
    X = rng.normal(size=(n, f)).astype(np.float32)
    coeff = (rng.normal(size=(cap, o))
             * (np.arange(cap) < t_cap)[:, None]).astype(np.float32)
    want = jpred.weighted_leaf_sum(cfg_j, ens_j, jnp.asarray(X),
                                   jnp.asarray(coeff))
    got = tpred.weighted_leaf_sum(_port_cfg(cfg_j), _port(ens_j), _t(X),
                                  _t(coeff))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_plain_ignores_trees_beyond_n_trees():
    """Stale nonzero weights at t >= n_trees contribute nothing; n_trees = 0
    gives zeros."""
    rng = np.random.default_rng(5)
    cfg_j, ens_j, cap = _random_ensemble(rng, 4, 2, 3, 5)
    ens = _port(ens_j)
    X = _t(rng.normal(size=(50, 4)).astype(np.float32))
    w = ens.leaf_values.clone()
    stale = w.clone()
    stale[5:] += 100.0
    for fn in (K.weighted_leaf_sum_plain, K.oblivious_leaf_sum_plain):
        a = fn(X, ens.feat, ens.thr, ens.is_split, w, 3, 5)
        b = fn(X, ens.feat, ens.thr, ens.is_split, stale, 3, 5)
        assert torch.equal(a, b)
        z = fn(X, ens.feat, ens.thr, ens.is_split, stale, 3, 0)
        assert torch.equal(z, torch.zeros_like(z))


@pytest.fixture(scope="module")
def fitted():
    """JAX-fitted greedy and oblivious ensembles (boost_step) plus inputs
    with exact x == threshold tie rows."""
    rng = np.random.default_rng(3)
    n, f, o, depth, t_fit = 300, 5, 3, 3, 12
    X = rng.normal(size=(n, f)).astype(np.float32)
    y = rng.normal(size=(n, o)).astype(np.float32)
    out = {}
    for policy in ("greedy", "oblivious"):
        cfg = j_cfg_from_dicts(
            f, o, dict(max_depth=depth, n_bins=32, min_data_in_leaf=0,
                       par_th=2, grow_policy=policy),
            dict(split_score_func="cosine", generator_type="Quantile"))
        cap = 1 << (2 * t_fit - 1).bit_length()
        ens = j_init_ensemble(cfg, capacity=cap)
        step = jax.jit(lambda e: boost_step(cfg, e, jnp.asarray(X),
                                            jnp.asarray(y),
                                            jnp.ones(f, jnp.float32)))
        for _ in range(t_fit):
            ens = step(ens)
        thr = np.asarray(ens.thr)
        Xe = X.copy()
        Xe[: n // 4, 0] = thr[0, 0]
        Xe[: n // 4, f - 1] = thr[3, 1]
        out[policy] = (cfg, ens, cap, Xe)
    return out


@pytest.mark.parametrize("policy", ["greedy", "oblivious"])
def test_fitted_ensemble_with_ties_matches_xla(fitted, policy):
    cfg_j, ens_j, cap, Xe = fitted[policy]
    specs = (JSpec(algo="SGD", init_lr=0.1, start_idx=0, stop_idx=3),)
    coeff = np.asarray(j_sgd_coeff(specs, cap, 3, ens_j.n_trees, 0, cap))
    want = jpred.weighted_leaf_sum(cfg_j, ens_j, jnp.asarray(Xe),
                                   jnp.asarray(coeff))
    got = tpred.weighted_leaf_sum(_port_cfg(cfg_j), _port(ens_j), _t(Xe),
                                  _t(coeff))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_oblivious_plain_bitwise_equals_k4_plain(fitted):
    cfg_j, ens_j, cap, Xe = fitted["oblivious"]
    ens = _port(ens_j)
    X = _t(Xe)
    w = ens.leaf_values * _t(np.random.default_rng(6).normal(
        size=(cap, 1, 3)).astype(np.float32))
    a = K.weighted_leaf_sum_plain(X, ens.feat, ens.thr, ens.is_split, w,
                                  cfg_j.max_depth, ens.n_trees)
    b = K.oblivious_leaf_sum_plain(X, ens.feat, ens.thr, ens.is_split, w,
                                   cfg_j.max_depth, ens.n_trees)
    assert torch.equal(a, b)


def test_categorical_walk_matches_jax():
    rng = np.random.default_rng(7)
    # as many categorical as numeric columns, so every random feat index
    # is valid in both blocks
    n, f, fc, o, depth = 120, 4, 4, 2, 3
    cfg_j, ens_j, cap = _random_ensemble(rng, f, o, depth, 6, cat=True)
    Xn = rng.normal(size=(n, f)).astype(np.float32)
    Xc = rng.integers(-1, 4, size=(n, fc)).astype(np.int32)
    e = ens_j
    want = jpred.chunk_leaf_rel(e.feat, e.thr, e.cat_code, e.is_split,
                                e.is_numeric, jnp.asarray(Xn),
                                jnp.asarray(Xc), depth)
    ens = _port(ens_j)
    got = tpred.chunk_leaf_rel(ens.feat, ens.thr, ens.cat_code, ens.is_split,
                               ens.is_numeric, _t(Xn), _t(Xc), depth)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    coeff = (rng.normal(size=(cap, o))
             * (np.arange(cap) < 6)[:, None]).astype(np.float32)
    want_s = jpred.weighted_leaf_sum(cfg_j, ens_j, jnp.asarray(Xn),
                                     jnp.asarray(coeff), jnp.asarray(Xc))
    got_s = tpred.weighted_leaf_sum(_port_cfg(cfg_j), ens, _t(Xn),
                                    _t(coeff), _t(Xc), tree_chunk=4)
    np.testing.assert_allclose(got_s.numpy(), np.asarray(want_s), **TOL)


def test_single_tree_gather_and_cv_momentum_match_jax(fitted):
    cfg_j, ens_j, cap, Xe = fitted["greedy"]
    cfg = _port_cfg(cfg_j)
    ens = _port(ens_j)
    X = jnp.asarray(Xe)
    tree_j = {k: getattr(ens_j, k)[4] for k in
              ("feat", "thr", "cat_code", "is_split", "is_numeric",
               "leaf_values")}
    tree = {k: getattr(ens, k)[4] for k in tree_j}
    np.testing.assert_allclose(
        tpred.single_tree_leaf_values(cfg, tree, _t(Xe)).numpy(),
        np.asarray(jpred.single_tree_leaf_values(cfg_j, tree_j, X)), **TOL)
    np.testing.assert_allclose(
        tpred.gather_leaf_values(cfg, ens, _t(Xe), tree_chunk=8).numpy(),
        np.asarray(jpred.gather_leaf_values(cfg_j, ens_j, X, tree_chunk=8)),
        **TOL)
    np.testing.assert_allclose(
        tpred.cv_momentum(cfg, ens, _t(Xe)).numpy(),
        np.asarray(jpred.cv_momentum(cfg_j, ens_j, X)), **TOL)


@pytest.mark.parametrize("case", ["greedy", "oblivious", "categorical"])
def test_chunk_leaf_indices_matches_jax(fitted, case):
    """chunk_leaf_indices gives gbrl_tpu's leaf indices (x == thr ties on
    the fitted ensembles; categorical nodes on a random one), and the same
    tensor as chunk_leaf_rel."""
    if case == "categorical":
        rng = np.random.default_rng(8)
        cfg_j, ens_j, _ = _random_ensemble(rng, 4, 2, 3, 6, cat=True)
        Xn = rng.normal(size=(90, 4)).astype(np.float32)
        Xc = rng.integers(-1, 4, size=(90, 4)).astype(np.int32)
    else:
        cfg_j, ens_j, _, Xn = fitted[case]
        Xc = None
    e, ens = ens_j, _port(ens_j)
    want = jpred.chunk_leaf_indices(
        e.feat, e.thr, e.cat_code, e.is_split, e.is_numeric, jnp.asarray(Xn),
        None if Xc is None else jnp.asarray(Xc), cfg_j.max_depth)
    args = (ens.feat, ens.thr, ens.cat_code, ens.is_split, ens.is_numeric,
            _t(Xn), None if Xc is None else _t(Xc), cfg_j.max_depth)
    got = tpred.chunk_leaf_indices(*args)
    assert got.shape == (len(Xn), ens.capacity)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert torch.equal(got, tpred.chunk_leaf_rel(*args))
