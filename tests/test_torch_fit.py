"""The port's fit ops against the JAX package on the CPU: candidates,
bucketize (K1), the level histogram (K2), the level split score (K3) and
whole trees.

Inputs are made with numpy from fixed seeds and handed to both packages.
The JAX functions that reach a Pallas kernel run in interpret mode, as the
JAX package's own tests run them.  Tolerances: candidates and bucket ids
bit-equal; histograms rtol = atol = 1e-5 (the sums are taken in another
order, as ``tests/test_pallas_kernels.py`` allows); split choice equal and
its scores within 1e-5; tree structure and counts equal, leaves within
1e-5."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gbrl_tpu.config import TreeConfig as JConfig
from gbrl_tpu.ops import boosting as jboost
from gbrl_tpu.ops import candidates as jcand
from gbrl_tpu.ops import fit as jfit
from gbrl_tpu.ops.pallas_kernels import (bucketize_pallas,
                                         level_histogram_pallas,
                                         level_score_pallas)

from gbrl_tpu_torch.config import TreeConfig
from gbrl_tpu_torch.ops import boosting as tboost
from gbrl_tpu_torch.ops import candidates as tcand
from gbrl_tpu_torch.ops import fit as tfit
from gbrl_tpu_torch.ops import kernels as K
from gbrl_tpu_torch.ops.loss import multirmse_grads, multirmse_loss

TOL = dict(rtol=1e-5, atol=1e-5)


def _t(a):
    return torch.from_numpy(np.array(a))


def _grid_data(rng, n, f, b):
    """Normal features with repeated values, x equal to quantile
    candidates and a column with few distinct values."""
    X = rng.normal(size=(n, f)).astype(np.float32)
    X[: n // 5, 0] = 0.25
    X[:, -1] = np.round(X[:, -1])
    return X


@pytest.mark.parametrize("generator", ["uniform", "quantile"])
@pytest.mark.parametrize("n,f,b", [(1000, 7, 32), (17, 3, 16), (64, 2, 1)])
def test_candidates_bit_equal(generator, n, f, b):
    X = _grid_data(np.random.default_rng(n + f), n, f, b)
    kw = dict(input_dim=f, output_dim=1, n_num_features=f, n_bins=b,
              generator_type=generator)
    want = np.asarray(jcand.numerical_candidates(JConfig(**kw),
                                                 jnp.asarray(X)))
    got = tcand.numerical_candidates(TreeConfig(**kw), _t(X)).numpy()
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))
    # the masked variant of fit_loop over the first rows of a padded array
    n_real = max(1, n - 5)
    Xp = X.copy()
    Xp[n_real:] = 99.0
    want = np.asarray(jboost._masked_candidates(
        JConfig(**kw), jnp.asarray(Xp), jnp.int32(n_real)))
    got = tboost._masked_candidates(TreeConfig(**kw), _t(Xp), n_real).numpy()
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))


@pytest.mark.parametrize("n,f,b", [(1000, 7, 32), (100, 1, 4)])
def test_bucketize_plain_matches_jax_and_pallas(n, f, b):
    rng = np.random.default_rng(b)
    X = _grid_data(rng, n, f, b)
    cfg = JConfig(input_dim=f, output_dim=1, n_num_features=f, n_bins=b)
    cand = np.asarray(jcand.numerical_candidates(cfg, jnp.asarray(X))).copy()
    cand[:, : b // 2] = cand[:, :1]                  # duplicate candidates
    X[: n // 10] = cand[:, b // 3][None, :]          # x equal to a candidate
    X[-3:] = np.nan                                  # NaN counts 0
    got = K.bucketize_plain(_t(X), _t(cand)).numpy()
    np.testing.assert_array_equal(
        got, np.asarray(jcand.bucketize(jnp.asarray(X), jnp.asarray(cand))))
    np.testing.assert_array_equal(
        got, np.asarray(bucketize_pallas(jnp.asarray(X), jnp.asarray(cand),
                                         interpret=True)))
    assert (got[-3:] == 0).all()
    np.testing.assert_array_equal(
        tcand.bucketize(_t(X), _t(cand)).numpy(), got)


def _special_columns(rng, n):
    """Columns with +-inf, NaN, -0.0 / +0.0 mixes and constant values."""
    X = rng.normal(size=(n, 6)).astype(np.float32)
    X[::7, 0] = np.inf
    X[::11, 0] = -np.inf
    X[::5, 1] = np.nan
    X[:, 2] = np.where(rng.random(n) < 0.5, -0.0, 0.0)
    X[::3, 2] = rng.normal(size=len(X[::3, 2]))
    X[:, 3] = 1.5
    X[::9, 4] = np.inf
    X[:, 5] = np.where(rng.random(n) < 0.5, -0.0, 0.0)
    return X


def _search(cand, X):
    """K1's search (csrc/fit.cu bucketize_kernel) in numpy: binary lifting
    to the length of the prefix of the row on which ``cand < x`` holds."""
    B = cand.shape[1]
    top = 1 << (B.bit_length() - 1)
    pos = np.zeros(X.shape, np.int32)
    f = np.arange(X.shape[1])[None, :]
    step = top
    while step:
        p = pos + step
        ok = p <= B
        pos = np.where(ok & (cand[f, np.minimum(p, B) - 1] < X), p, pos)
        step >>= 1
    return pos


@pytest.mark.parametrize("generator", ["uniform", "quantile"])
def test_bucketize_special_grids(generator):
    """Grids from columns with +-inf, NaN, +-0.0 and constant values: the
    port's grid bit-equal to the JAX package's; bucketize_plain equal to
    JAX's bucketize and to bucketize_pallas (interpret); and K1's lower-bound
    search (emulated) equal to the count, since ``cand < x`` holds on a
    prefix of every such row."""
    rng = np.random.default_rng(11)
    X = _special_columns(rng, 300)
    kw = dict(input_dim=6, output_dim=1, n_num_features=6, n_bins=32,
              generator_type=generator)
    cand = np.asarray(jcand.numerical_candidates(JConfig(**kw),
                                                 jnp.asarray(X)))
    tc = tcand.numerical_candidates(TreeConfig(**kw), _t(X)).numpy()
    np.testing.assert_array_equal(tc.view(np.int32), cand.view(np.int32))
    probe = np.concatenate([X, np.tile(np.array(
        [[np.inf], [-np.inf], [np.nan], [-0.0], [0.0], [1.5]], np.float32),
        (1, 6)), cand[:, ::3].T], axis=0)
    got = K.bucketize_plain(_t(probe), _t(cand)).numpy()
    np.testing.assert_array_equal(
        got, np.asarray(jcand.bucketize(jnp.asarray(probe),
                                        jnp.asarray(cand))))
    np.testing.assert_array_equal(
        got, np.asarray(bucketize_pallas(jnp.asarray(probe),
                                         jnp.asarray(cand), interpret=True)))
    np.testing.assert_array_equal(_search(cand, probe), got)
    assert (got[np.isnan(probe)] == 0).all()


@pytest.mark.parametrize("n,f,o,n_nodes,buckets",
                         [(1000, 7, 3, 4, 33), (100, 1, 2, 8, 9)])
def test_level_histogram_plain_matches_jax(n, f, o, n_nodes, buckets):
    rng = np.random.default_rng(1)
    Xb = rng.integers(0, buckets, size=(n, f)).astype(np.int32)
    g = rng.normal(size=(n, o)).astype(np.float32)
    sw = (rng.random(n) > 0.1).astype(np.float32)
    node_rel = rng.integers(0, n_nodes, size=(n,)).astype(np.int32)
    nd = tfit._node_expand(_t(node_rel), _t(g), _t(sw), n_nodes)
    jnd = jfit._node_expand(jnp.asarray(node_rel), jnp.asarray(g),
                            jnp.asarray(sw), n_nodes)
    np.testing.assert_array_equal(nd.numpy(), np.asarray(jnd))
    got = K.level_histogram_plain(_t(Xb), nd, buckets).numpy()   # [F, C, NB]
    want = np.asarray(level_histogram_pallas(jnp.asarray(Xb), jnd, buckets,
                                             interpret=True))
    np.testing.assert_allclose(got, want, **TOL)
    # the segment sum of the JAX package's non-TPU path
    seg = np.asarray(jfit._level_histogram(
        jnp.asarray(Xb), jnp.asarray(node_rel), jnp.asarray(g),
        jnp.asarray(sw), n_nodes, buckets))                # [F, n, NB, O+1]
    np.testing.assert_allclose(
        got.reshape(f, n_nodes, o + 1, buckets).transpose(0, 1, 3, 2), seg,
        **TOL)
    port = tfit._level_histogram(_t(Xb), _t(node_rel), _t(g), _t(sw),
                                 n_nodes, buckets).numpy()
    np.testing.assert_allclose(port, seg, **TOL)


def _pallas_score(hist, blocked, fw, B, O, score, md, oblivious, is_root):
    """level_score_pallas (interpret) on the port's [F, C, NB] histogram."""
    F, C, NB = hist.shape
    n_nodes = blocked.shape[0]
    BP = -(-NB // 128) * 128
    NP = -(-n_nodes // 8) * 8
    raw = np.zeros((C, F, BP), np.float32)
    raw[:, :, :NB] = hist.transpose(1, 0, 2)
    blk = np.ones((NP, F, BP), np.float32)
    blk[:n_nodes, :, :B] = blocked
    packed = np.asarray(level_score_pallas(
        jnp.asarray(raw.reshape(C, F * BP)),
        jnp.asarray(blk.reshape(NP, F * BP)),
        jnp.asarray(np.repeat(fw, BP)[None, :]), n_bins=B, n_buckets=NB,
        n_nodes=n_nodes, out_dim=O, score=score, min_data=md,
        oblivious=oblivious, is_root=is_root, interpret=True))
    return packed[:n_nodes]


@pytest.mark.parametrize("oblivious", [False, True])
@pytest.mark.parametrize("score", ["cosine", "l2"])
@pytest.mark.parametrize("n_nodes,min_data", [(1, 0), (4, 25)])
def test_level_score_plain_matches_pallas(oblivious, score, n_nodes,
                                          min_data):
    rng = np.random.default_rng(3 + n_nodes + min_data)
    N, F, O, B = 600, 4, 3, 16
    X = rng.normal(size=(N, F)).astype(np.float32)
    cfg = JConfig(input_dim=F, output_dim=O, n_num_features=F, n_bins=B)
    cand = jcand.numerical_candidates(cfg, jnp.asarray(X))
    Xb = K.bucketize_plain(_t(X), _t(cand))
    g = _t(rng.normal(size=(N, O)).astype(np.float32))
    node_rel = _t(rng.integers(0, n_nodes, N).astype(np.int32))
    nd = tfit._node_expand(node_rel, g, torch.ones(N), n_nodes)
    hist = K.level_histogram_plain(Xb, nd, B + 1)
    blocked = rng.random((n_nodes, F, B)) < (0.0 if n_nodes == 1 else 0.1)
    fw = rng.uniform(0.5, 2.0, F).astype(np.float32)
    fw[1] = 0.0                                       # a zero feature weight
    is_root = n_nodes == 1
    idx, best, cnt, parent, sums = K.level_score_plain(
        hist, _t(blocked), _t(fw), B, O, score, min_data, oblivious, is_root)
    packed = _pallas_score(hist.numpy(), blocked, fw, B, O, score, min_data,
                           oblivious, is_root)
    np.testing.assert_array_equal(idx.numpy(), packed[:, 0].astype(np.int32))
    np.testing.assert_allclose(best.numpy(), packed[:, 1], **TOL)
    np.testing.assert_allclose(cnt.numpy(), packed[:, 2], **TOL)
    np.testing.assert_allclose(sums.numpy(), packed[:, 8:8 + O], **TOL)
    if not oblivious:
        np.testing.assert_allclose(parent.numpy(), packed[:, 3], **TOL)
    # the CPU branch of the wrapper is the plain version
    again = K.level_score_cuda(hist, _t(blocked), _t(fw), B, O, score,
                               min_data, oblivious, is_root)
    assert all(torch.equal(a, b) for a, b in zip(again, (idx, best, cnt,
                                                          parent, sums)))


def _assert_tree_equal(got: dict, want: dict):
    for k in ("feat", "is_split", "cat_code", "is_numeric", "depth"):
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]),
                                      err_msg=k)
    np.testing.assert_array_equal(got["thr"].numpy(), np.asarray(want["thr"]))
    np.testing.assert_array_equal(got["counts"].numpy(),
                                  np.asarray(want["counts"]))
    np.testing.assert_allclose(got["leaf_values"].numpy(),
                               np.asarray(want["leaf_values"]), **TOL)


TREE_CASES = {
    "greedy-cosine": dict(grow_policy="greedy", split_score_func="cosine"),
    "greedy-l2": dict(grow_policy="greedy", split_score_func="l2"),
    "oblivious-cosine": dict(grow_policy="oblivious",
                             split_score_func="cosine"),
    "oblivious-l2": dict(grow_policy="oblivious", split_score_func="l2"),
    "greedy-min-data-masked-weights": dict(
        grow_policy="greedy", split_score_func="cosine", min_data_in_leaf=40,
        masked=True, zero_w=True),
    "oblivious-min-data-masked-weights": dict(
        grow_policy="oblivious", split_score_func="l2", min_data_in_leaf=30,
        masked=True, zero_w=True, generator_type="uniform"),
    "greedy-categorical": dict(grow_policy="greedy",
                               split_score_func="cosine", categorical=True),
    "oblivious-categorical": dict(grow_policy="oblivious",
                                  split_score_func="l2", categorical=True),
}


@pytest.mark.parametrize("case", sorted(TREE_CASES))
def test_build_tree_matches_jax(case):
    opts = dict(TREE_CASES[case])
    masked = opts.pop("masked", False)
    zero_w = opts.pop("zero_w", False)
    categorical = opts.pop("categorical", False)
    rng = np.random.default_rng(sorted(TREE_CASES).index(case) + 20)
    N, F, O, B, D, Fc, V = 700, 5, 3, 16, 4, 2, 8
    kw = dict(input_dim=F + (Fc if categorical else 0), output_dim=O,
              n_num_features=F, n_cat_features=Fc if categorical else 0,
              max_depth=D, n_bins=B, **opts)
    jc, tc = JConfig(**kw), TreeConfig(**kw)
    X = rng.normal(size=(N, F)).astype(np.float32)
    g = rng.normal(size=(N, O)).astype(np.float32)
    w = ((rng.random(N) > 0.2) if masked else np.ones(N)).astype(np.float32)
    fw = rng.uniform(0.5, 1.5, F).astype(np.float32)
    if zero_w:
        fw[2] = 0.0
    build = g if jc.score == "cosine" else np.asarray(
        jfit.standardize_l2(jnp.asarray(g), jnp.asarray(w)))
    cand = jcand.numerical_candidates(jc, jnp.asarray(X))
    Xb = jcand.bucketize(jnp.asarray(X), cand)
    jargs = [jnp.asarray(a) for a in (g, build, w, fw)]
    targs = [_t(a) for a in (g, build, w, fw)]
    jextra, textra = [], []
    if categorical:
        Xc = rng.integers(0, V, size=(N, Fc)).astype(np.int32)
        fwc = rng.uniform(0.5, 1.5, Fc).astype(np.float32)
        valid = np.asarray(jcand.categorical_candidate_mask(
            jnp.asarray(Xc), jnp.asarray((g * g).sum(1)), B, V,
            jnp.asarray(w)))
        tvalid = tcand.categorical_candidate_mask(
            _t(Xc), _t((g * g).sum(1)), B, V, _t(w))
        np.testing.assert_array_equal(tvalid.numpy(), valid)
        jextra = [jnp.asarray(Xc), jnp.asarray(valid), jnp.asarray(fwc)]
        textra = [_t(Xc), tvalid, _t(fwc)]
    want = jax.jit(jfit.build_tree, static_argnums=0)(jc, Xb, cand, *jargs,
                                                      *jextra)
    got = tfit.build_tree(tc, _t(Xb), _t(cand), *targs, *textra)
    _assert_tree_equal(got, want)
    assert int(got["is_split"].sum()) > 0


def test_standardize_l2_cv_adjust_and_loss():
    rng = np.random.default_rng(5)
    g = rng.normal(size=(300, 3)).astype(np.float32)
    g[:, 2] = 0.7                                      # zero variance
    mom = rng.normal(size=(300, 3)).astype(np.float32)
    w = (rng.random(300) > 0.3).astype(np.float32)
    np.testing.assert_allclose(
        tfit.standardize_l2(_t(g), _t(w)).numpy(),
        np.asarray(jfit.standardize_l2(jnp.asarray(g), jnp.asarray(w))),
        rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(
        tboost._cv_adjust(_t(g), _t(mom), _t(w)).numpy(),
        np.asarray(jboost._cv_adjust(jnp.asarray(g), jnp.asarray(mom),
                                     jnp.asarray(w))), rtol=1e-6, atol=1e-6)
    from gbrl_tpu.ops import loss as jloss
    tg, tl = multirmse_grads(_t(g), _t(mom), _t(w))
    jg, jl = jloss.multirmse_grads(jnp.asarray(g), jnp.asarray(mom),
                                   jnp.asarray(w))
    np.testing.assert_allclose(tg.numpy(), np.asarray(jg), rtol=1e-6)
    np.testing.assert_allclose(float(tl), float(jl), rtol=1e-6)
    np.testing.assert_allclose(float(multirmse_loss(_t(g), _t(mom), _t(w))),
                               float(jl), rtol=1e-6)
