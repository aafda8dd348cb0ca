"""K1-K6 CUDA kernels against their plain versions, on the card (K4 / K5
over a grid of N, F, O, depth and n_trees, past the old shared-memory
ceiling, with the coefficients apart; K3 at wide O).

Marked ``cuda``: every test takes the ``cuda_device`` fixture, which skips
when PyTorch sees no CUDA device (CUDA kernels have no CPU mode).  Run on a
machine with an H100:
``python -m pytest tests/test_torch_kernels_cuda.py -q -m cuda``."""
import numpy as np
import pytest
import torch

from gbrl_tpu_torch.ops import kernels as K

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the CUDA kernels run only on the "
                    "card")
    return torch.device("cuda")


def _ensemble(rng, oblivious, T, F, O, D):
    IN, L = (1 << D) - 1, 1 << D
    if oblivious:
        feat = np.empty((T, IN), np.int32)
        thr = np.empty((T, IN), np.float32)
        spl = np.empty((T, IN), bool)
        for d in range(D):
            lo, k = (1 << d) - 1, 1 << d
            s = rng.random(T) > 0.2
            feat[:, lo:lo + k] = np.where(s, rng.integers(0, F, T), -1)[:, None]
            thr[:, lo:lo + k] = rng.normal(size=T)[:, None]
            spl[:, lo:lo + k] = s[:, None]
    else:
        feat = rng.integers(-1, F, (T, IN)).astype(np.int32)
        thr = rng.normal(size=(T, IN)).astype(np.float32)
        spl = rng.random((T, IN)) > 0.25
    w = rng.normal(size=(T, L, O)).astype(np.float32)
    return feat, thr, spl, w


@pytest.mark.parametrize("n,F,O,D,T,nt", [(4096, 16, 3, 4, 2048, 1600),
                                          (1000, 16, 3, 4, 256, 129),
                                          (37, 5, 11, 3, 16, 1),
                                          (100, 300, 2, 6, 64, 40),
                                          (300, 16, 3, 10, 24, 20),
                                          (64, 4, 2, 2, 8, 0)])
def test_kernels_match_plain(cuda_device, n, F, O, D, T, nt):
    rng = np.random.default_rng(n + D)
    for obl in (False, True):
        feat, thr, spl, w = _ensemble(rng, obl, T, F, O, D)
        X = rng.normal(size=(n, F)).astype(np.float32)
        X[: n // 4, max(feat[0, 0], 0)] = thr[0, 0]       # x == thr ties
        X[-1] = np.nan                                     # NaN goes left
        t = [torch.from_numpy(a).to(cuda_device) for a in (X, feat, thr, spl, w)]
        ntd = torch.tensor(nt, dtype=torch.int32, device=cuda_device)
        want = K.weighted_leaf_sum_plain(*t, D, nt)
        k4 = K.weighted_leaf_sum_cuda(*t, D, ntd)
        # the kernel sums the trees in another order than the plain
        # version: hold the error to 1e-5 of the output's scale
        err = (k4 - want).abs().max().item() if n else 0.0
        assert err <= 1e-5 * want.abs().max().item() + 1e-6, err
        if obl:
            k5 = K.oblivious_leaf_sum_cuda(*t, D, ntd)
            assert torch.equal(k5, k4)


def test_wrapper_rejects_bad_inputs(cuda_device):
    X = torch.zeros((4, 3), device=cuda_device)
    feat = torch.zeros((8, 7), dtype=torch.int32, device=cuda_device)
    thr = torch.zeros((8, 7), device=cuda_device)
    spl = torch.zeros((8, 7), dtype=torch.bool, device=cuda_device)
    w = torch.zeros((8, 8, 2), device=cuda_device)
    nt = torch.tensor(8, dtype=torch.int32, device=cuda_device)
    with pytest.raises(ValueError):
        K.weighted_leaf_sum_cuda(X, feat.float(), thr, spl, w, 3, nt)
    with pytest.raises(ValueError):
        K.weighted_leaf_sum_cuda(X.t(), feat, thr, spl, w, 3, nt)
    with pytest.raises(ValueError):
        K.oblivious_leaf_sum_cuda(X, feat, thr, spl, w, 3, nt.cpu())


def test_wrapper_raises_past_shared_memory_ceiling(cuda_device):
    """K4 at depth 12 (F = 16, O = 3), where a group of trees does not fit
    a block's shared memory: the wrapper once raised here; now the plan
    takes the global route and the kernel matches its plain version."""
    D, T, n = 12, 8, 300
    assert not K._predict_plan(n, 16, T, D, 3, False).staged
    rng = np.random.default_rng(12)
    for obl in (False, True):
        feat, thr, spl, w = _ensemble(rng, obl, T, 16, 3, D)
        X = rng.normal(size=(n, 16)).astype(np.float32)
        X[-1] = np.nan
        t = [torch.from_numpy(a).to(cuda_device) for a in (X, feat, thr, spl, w)]
        nt = torch.tensor(T - 1, dtype=torch.int32, device=cuda_device)
        got = K.weighted_leaf_sum_cuda(*t, D, nt)
        want = K.weighted_leaf_sum_plain(*t, D, T - 1)
        torch.cuda.synchronize()
        err = (got - want).abs().max().item()
        assert err <= 1e-5 * want.abs().max().item() + 1e-6, err
        if obl:
            assert torch.equal(K.oblivious_leaf_sum_cuda(*t, D, nt), got)


# the grid of the redesigned K4 / K5: every depth x O pair, N and F in turn;
# then AWR's minibatch on both sides of the warp-group boundary
# PREDICT_SPLIT_N (Pendulum's F = 3, O = 1) and SAC's batch (O = 2)
PREDICT_GRID = [(n, f, o, d) for i, (d, o) in enumerate(
    (d, o) for d in (1, 4, 8, 11) for o in (1, 3, 8, 11, 19))
    for n, f in [((1, 1000, 4096)[i % 3], (1, 16, 300)[(i // 3) % 3])]]
PREDICT_GRID += [(K.PREDICT_SPLIT_N, 3, 1, 4),
                 (K.PREDICT_SPLIT_N + 1, 3, 1, 4), (256, 3, 2, 4)]


@pytest.mark.parametrize("n,F,O,D", PREDICT_GRID)
def test_predict_grid_matches_plain(cuda_device, n, F, O, D):
    """K4 (greedy) and K4 / K5 (oblivious) with the coefficients given
    apart, at n_trees in {0, 1, 129, T_cap}: within RTOL * max|plain| +
    ATOL of the plain version; the same bits on two launches; the same bits
    as the pre-scaled path; K5 equal to K4 bit for bit; one launch each."""
    T = 160
    rng = np.random.default_rng(n + 31 * F + 7 * O + D)
    for obl in (False, True):
        feat, thr, spl, lv = _ensemble(rng, obl, T, F, O, D)
        coeff = rng.uniform(-0.1, 0.1, (T, O)).astype(np.float32)
        X = rng.normal(size=(n, F)).astype(np.float32)
        X[: n // 4, max(feat[0, 0], 0)] = thr[0, 0]       # x == thr ties
        X[-1] = np.nan
        t = [torch.from_numpy(a).to(cuda_device)
             for a in (X, feat, thr, spl, lv, coeff)]
        w = t[4] * t[5][:, None, :]
        for nt in (0, 1, 129, T):
            ntd = torch.tensor(nt, dtype=torch.int32, device=cuda_device)
            before = dict(K.launch_counts)
            k4 = K.weighted_leaf_sum_cuda(*t[:5], D, ntd, t[5])
            again = K.weighted_leaf_sum_cuda(*t[:5], D, ntd, t[5])
            pre = K.weighted_leaf_sum_cuda(*t[:4], w, D, ntd)
            want = K.weighted_leaf_sum_plain(*t[:5], D, nt, t[5])
            torch.cuda.synchronize()
            assert K.launch_counts["weighted_leaf_sum"] == \
                before["weighted_leaf_sum"] + 3
            assert torch.equal(k4, again) and torch.equal(k4, pre)
            err = (k4 - want).abs().max().item()
            assert err <= 1e-5 * want.abs().max().item() + 1e-6, (nt, err)
            if nt == 0:
                assert torch.equal(k4, torch.zeros_like(k4))
            if obl:
                k5 = K.oblivious_leaf_sum_cuda(*t[:5], D, ntd, t[5])
                assert torch.equal(k5, k4), nt
                assert torch.equal(
                    K.oblivious_leaf_sum_cuda(*t[:4], w, D, ntd), k4)


def test_prefix_stop_reads_only_the_prefix(cuda_device):
    """SAC's target predict: ``predict_sgd`` with a device stop tree
    below n_trees (256 rows, F = 3, O = 2, oblivious) launches K5 once and
    equals the plain version of an ensemble cut to the prefix."""
    from gbrl_tpu_torch.config import TreeConfig
    from gbrl_tpu_torch.ensemble import ensemble_from_numpy
    from gbrl_tpu_torch.ops.boosting import predict_sgd
    from gbrl_tpu_torch.optimizers import OptimizerSpec
    rng = np.random.default_rng(5)
    T, nt, prefix, D = 512, 250, 200, 4
    feat, thr, spl, lv = _ensemble(rng, True, T, 3, 2, D)
    arrs = dict(feat=feat, thr=thr, cat_code=np.full_like(feat, -1),
                is_split=spl, is_numeric=np.ones_like(spl),
                leaf_values=lv, counts=np.zeros((T, 2 * (1 << D) - 1),
                                                np.float32),
                depths=np.full(T, D, np.int32),
                bias=rng.normal(size=2).astype(np.float32),
                n_trees=np.asarray(nt, np.int32))
    cfg = TreeConfig(input_dim=3, output_dim=2, n_num_features=3,
                     max_depth=D, grow_policy="oblivious")
    specs = (OptimizerSpec.from_dict(dict(algo="SGD", init_lr=0.1,
                                          start_idx=0, stop_idx=1)),
             OptimizerSpec.from_dict(dict(algo="SGD", init_lr=0.05,
                                          start_idx=1, stop_idx=2)))
    X = rng.normal(size=(256, 3)).astype(np.float32)
    stop = torch.tensor(prefix, dtype=torch.int32, device=cuda_device)
    before = K.launch_counts["oblivious_leaf_sum"]
    got = predict_sgd(cfg, ensemble_from_numpy(arrs, "cuda"),
                      torch.from_numpy(X).to(cuda_device), specs, 0, stop)
    torch.cuda.synchronize()
    assert K.launch_counts["oblivious_leaf_sum"] == before + 1
    arrs["n_trees"] = np.asarray(prefix, np.int32)
    want = predict_sgd(cfg, ensemble_from_numpy(arrs, "cpu"),
                       torch.from_numpy(X), specs, 0, T)
    err = (got.cpu() - want).abs().max().item()
    assert err <= 1e-5 * want.abs().max().item() + 1e-6, err


# ------------------------------------------------------------ fit kernels
def _fit_inputs(rng, dev, n, f, b, n_nodes, o=3):
    from gbrl_tpu_torch.ops.fit import _node_expand
    X = rng.normal(size=(n, f)).astype(np.float32)
    cand = np.sort(rng.normal(size=(f, b)).astype(np.float32), axis=1)
    cand[:, b // 4:b // 4 + 3] = cand[:, b // 4:b // 4 + 1]   # duplicates
    X[: n // 8] = cand[:, b // 2][None, :]                    # x == candidate
    X[-2:] = np.nan
    Xd, cd = (torch.from_numpy(a).to(dev) for a in (X, cand))
    rel = torch.from_numpy(rng.integers(0, n_nodes, n).astype(np.int32)).to(dev)
    g = torch.from_numpy(rng.normal(size=(n, o)).astype(np.float32)).to(dev)
    nd = _node_expand(rel, g, torch.ones(n, device=dev), n_nodes)
    return Xd, cd, nd


@pytest.mark.parametrize("n,f,b", [(4096, 16, 256), (1000, 300, 256),
                                   (33, 3, 1), (5, 2, 3000),
                                   (300, 3, 40000)])   # candidate ranges
def test_bucketize_bit_equal(cuda_device, n, f, b):
    Xd, cd, _ = _fit_inputs(np.random.default_rng(n), cuda_device, n, f, b, 1)
    got = K.bucketize_cuda(Xd, cd)
    torch.cuda.synchronize()
    assert torch.equal(got, K.bucketize_plain(Xd, cd))
    assert torch.equal(got.cpu(), K.bucketize_plain(Xd.cpu(), cd.cpu()))


@pytest.mark.parametrize("n,f,nb,n_nodes", [(4096, 16, 257, 8),
                                            (4096, 16, 257, 1),
                                            (1000, 300, 257, 2),
                                            (777, 5, 1025, 4), (10, 3, 9, 2)])
def test_level_histogram_deterministic(cuda_device, n, f, nb, n_nodes):
    Xd, cd, nd = _fit_inputs(np.random.default_rng(f), cuda_device, n, f,
                             nb - 1, n_nodes)
    Xb = K.bucketize_cuda(Xd, cd)
    first = K.level_histogram_cuda(Xb, nd, nb)
    for _ in range(3):
        assert torch.equal(K.level_histogram_cuda(Xb, nd, nb), first)
    # the plain version adds in another order (index_add_): 1e-5 of scale
    want = K.level_histogram_plain(Xb, nd, nb)
    err = (first - want).abs().max().item()
    assert err <= 1e-5 * want.abs().max().item() + 1e-6, err


@pytest.mark.parametrize("n,f,nb,C", [(10, 3, 257, 8), (33, 4, 257, 4),
                                      (777, 5, 257, 32), (1000, 4, 257, 1),
                                      (500, 4, 1, 8), (777, 5, 1025, 16),
                                      (1000, 300, 257, 8),
                                      (300, 2, 100_000, 4)])
def test_level_histogram_cluster_shapes(cuda_device, n, f, nb, C):
    """K2 at shapes that stress its cluster plan: fewer samples than one
    cluster's worth, N not a multiple of 32, one column, one bucket, bucket
    ranges, F = 300; bucket ids outside [0, nb), rows of zero weight and
    -0.0 entries in nd.  The same bits on three launches; within 1e-5 of
    scale of the plain version; a bin whose terms are all zero or -0.0 is
    +0.0, as the plain version's."""
    rng = np.random.default_rng(n + f + C)
    Xb = rng.integers(-1, nb + 1, size=(n, f)).astype(np.int32)
    nd = rng.normal(size=(n, C)).astype(np.float32)
    nd[rng.random((n, C)) < 0.6] = 0.0
    nd[::4] = 0.0                                      # zero-weight rows
    nd[1::9, 0] = -0.0
    Xd, ndd = (torch.from_numpy(a).to(cuda_device) for a in (Xb, nd))
    first = K.level_histogram_cuda(Xd, ndd, nb)
    for _ in range(2):
        assert torch.equal(K.level_histogram_cuda(Xd, ndd, nb), first)
    want = K.level_histogram_plain(Xd, ndd, nb)
    torch.cuda.synchronize()
    err = (first - want).abs().max().item()
    assert err <= 1e-5 * want.abs().max().item() + 1e-6, err
    zero = want == 0
    assert torch.equal(torch.signbit(first[zero]), torch.signbit(want[zero]))


def _special_columns(rng, n):
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


@pytest.mark.parametrize("generator", ["uniform", "quantile"])
@pytest.mark.parametrize("n,b", [(4096, 256), (513, 16)])
def test_bucketize_special_grids(cuda_device, generator, n, b):
    """K1 on grids built from columns with +-inf, NaN, -0.0 / +0.0 and
    constant values: bit-equal to the plain version on the card and on the
    CPU, the special values themselves among the inputs."""
    from gbrl_tpu_torch.config import TreeConfig
    from gbrl_tpu_torch.ops import candidates as C
    X = _special_columns(np.random.default_rng(n + b), n)
    X[:6] = np.array([np.inf, -np.inf, np.nan, -0.0, 0.0, 1.5],
                     np.float32)[:, None]
    cfg = TreeConfig(input_dim=6, output_dim=1, n_num_features=6, n_bins=b,
                     generator_type=generator)
    Xd = torch.from_numpy(X).to(cuda_device)
    cand = C.numerical_candidates(cfg, Xd)
    got = K.bucketize_cuda(Xd, cand)
    torch.cuda.synchronize()
    assert torch.equal(got, K.bucketize_plain(Xd, cand))
    assert torch.equal(got.cpu(), K.bucketize_plain(Xd.cpu(), cand.cpu()))


@pytest.mark.parametrize("oblivious", [False, True])
@pytest.mark.parametrize("score", ["cosine", "l2"])
@pytest.mark.parametrize("n_nodes,min_data", [(1, 0), (8, 0), (8, 30)])
def test_level_score_matches_plain(cuda_device, oblivious, score, n_nodes,
                                   min_data):
    rng = np.random.default_rng(n_nodes + min_data)
    F, B = 16, 256
    Xd, cd, nd = _fit_inputs(rng, cuda_device, 4096, F, B, n_nodes)
    hist = K.level_histogram_cuda(K.bucketize_cuda(Xd, cd), nd, B + 1)
    blocked = torch.from_numpy(rng.random((n_nodes, F, B)) < 0.05
                               ).to(cuda_device)
    fw = torch.from_numpy(rng.uniform(0.5, 1.5, F).astype(np.float32)
                          ).to(cuda_device)
    fw[3] = 0.0
    args = (hist, blocked, fw, B, 3, score, min_data, oblivious, n_nodes == 1)
    got = K.level_score_cuda(*args)
    want = K.level_score_plain(*args)
    torch.cuda.synchronize()
    # the kernel repeats the plain version's arithmetic: equal bits
    for a, b in zip(got, want):
        assert torch.equal(a, b)


def _score_args(rng, dev, F, n_nodes, O, oblivious, score, min_data,
                B=256, case=None):
    """K3's arguments from a histogram of random bucket ids and node rows:
    ``case`` "empty_node" leaves node 0 without samples, "blocked_feature"
    blocks feature 1 at every node, "neg_inf_row" blocks every candidate of
    node 0 (greedy: an all -inf row; oblivious: every node)."""
    n = 3000
    Xb = rng.integers(0, B + 1, (n, F)).astype(np.int32)
    rel = rng.integers(0, n_nodes, n)
    if case == "empty_node" and n_nodes > 1:
        rel[rel == 0] = 1
    rows = np.concatenate([rng.normal(size=(n, O)),
                           np.ones((n, 1))], 1).astype(np.float32)
    nd = np.zeros((n, n_nodes, O + 1), np.float32)
    nd[np.arange(n), rel] = rows
    hist = K.level_histogram_plain(torch.from_numpy(Xb),
                                   torch.from_numpy(nd.reshape(n, -1)), B + 1)
    blocked = rng.random((n_nodes, F, B)) < 0.05
    if case == "blocked_feature":
        blocked[:, 1 % F] = True
    if case == "neg_inf_row":
        blocked[:n_nodes if oblivious else 1] = True
    fw = rng.uniform(0.5, 1.5, F).astype(np.float32)
    fw[F // 2] = 0.0
    return (hist.to(dev), torch.from_numpy(blocked).to(dev),
            torch.from_numpy(fw).to(dev), B, O, score, min_data, oblivious,
            n_nodes == 1)


@pytest.mark.parametrize("F,n_nodes,O,oblivious,score,min_data,case", [
    (4, 1, 3, False, "cosine", 0, None),             # the PPO shape
    (4, 8, 3, False, "l2", 20, None),
    (4, 8, 3, True, "cosine", 20, None),
    (16, 8, 3, True, "l2", 0, None),                 # oblivious, 8 nodes
    (300, 1, 3, False, "cosine", 0, None),
    (300, 8, 3, True, "cosine", 10, None),
    (16, 16, 3, False, "cosine", 0, None),           # greedy past depth 4
    (16, 512, 3, False, "l2", 5, None),
    (16, 8, 3, False, "cosine", 30, "empty_node"),
    (16, 8, 3, True, "cosine", 30, "empty_node"),
    (16, 4, 3, False, "l2", 0, "blocked_feature"),
    (16, 4, 3, False, "cosine", 0, "neg_inf_row"),
    (16, 4, 3, True, "cosine", 0, "neg_inf_row"),
    (16, 8, 1, False, "cosine", 0, None),
    (16, 8, 8, True, "l2", 0, None),
    (5, 2, 8, False, "cosine", 0, None),
])
def test_level_score_shapes(cuda_device, F, n_nodes, O, oblivious, score,
                            min_data, case):
    """K3 across its plan: few and many features per cluster, many greedy
    nodes, oblivious levels, a node without samples, a fully blocked
    feature, an all -inf row, O = 1 and 8.  Bit-equal to the plain version
    on every output, and the same bits on three launches."""
    rng = np.random.default_rng(F * 1000 + n_nodes + O)
    args = _score_args(rng, cuda_device, F, n_nodes, O, oblivious, score,
                       min_data, case=case)
    before = K.launch_counts["level_score"]
    runs = [K.level_score_cuda(*args) for _ in range(3)]
    want = K.level_score_plain(*args)
    torch.cuda.synchronize()
    assert K.launch_counts["level_score"] == before + 3
    for got in runs:
        for a, b in zip(got, want):
            assert a.shape == b.shape and a.dtype == b.dtype
            assert torch.equal(a, b)


@pytest.mark.parametrize("oblivious", [False, True])
@pytest.mark.parametrize("O", [256, 300])
def test_level_score_wide_outputs(cuda_device, O, oblivious):
    """K3 at O = 256 and 300 (256 bins), where even one (node, feature)'s
    staged rows exceed the shared-memory budget: the plan stages them in
    global scratch, and the kernel's chosen indices equal its plain
    version's, its values within 1e-6 of scale; the same bits twice."""
    F, n_nodes = 16, 8
    assert K._score_plan(F, n_nodes, O, 256, oblivious).glob
    rng = np.random.default_rng(O + oblivious)
    args = _score_args(rng, cuda_device, F, n_nodes, O, oblivious, "cosine",
                       10)
    got = K.level_score_cuda(*args)
    again = K.level_score_cuda(*args)
    want = K.level_score_plain(*args)
    torch.cuda.synchronize()
    for a, b in zip(got, again):
        assert torch.equal(a, b)
    assert torch.equal(got[0], want[0])
    for a, b in zip(got[1:], want[1:]):
        fin = torch.isfinite(b)
        assert torch.equal(fin, torch.isfinite(a))
        assert torch.equal(a[~fin], b[~fin])
        if fin.any():
            err = (a[fin] - b[fin]).abs().max().item()
            assert err <= 1e-6 * b[fin].abs().max().item(), err


def test_build_tree_on_card_matches_cpu(cuda_device):
    from gbrl_tpu_torch.config import TreeConfig
    from gbrl_tpu_torch.ops import candidates as C
    from gbrl_tpu_torch.ops.fit import build_tree
    rng = np.random.default_rng(9)
    X = rng.normal(size=(2000, 8)).astype(np.float32)
    g = rng.normal(size=(2000, 3)).astype(np.float32)
    for policy in ("greedy", "oblivious"):
        cfg = TreeConfig(input_dim=8, output_dim=3, n_num_features=8,
                         max_depth=4, n_bins=32, grow_policy=policy)
        trees = []
        for dev in (cuda_device, torch.device("cpu")):
            Xt, gt = (torch.from_numpy(a).to(dev) for a in (X, g))
            cand = C.numerical_candidates(cfg, Xt)
            trees.append(build_tree(cfg, C.bucketize(Xt, cand), cand, gt, gt,
                                    torch.ones(2000, device=dev),
                                    torch.ones(8, device=dev)))
        card, cpu = ({k: v.cpu() for k, v in t.items()} for t in trees)
        for k in ("feat", "is_split", "thr", "counts", "depth"):
            assert torch.equal(card[k], cpu[k]), k
        assert torch.allclose(card["leaf_values"], cpu["leaf_values"],
                              rtol=1e-5, atol=1e-6)


def _tree_args(rng, dev, n, f, depth, score, min_data, oblivious, o=3,
               b=256):
    from gbrl_tpu_torch.ops.fit import _weighted_rows
    X = rng.normal(size=(n, f)).astype(np.float32)
    X[: n // 8, 0] = 0.25                                     # repeats
    cand = torch.from_numpy(np.sort(np.quantile(
        X, np.linspace(0, 1, b + 2)[1:-1], axis=0).T, axis=1)
        .astype(np.float32)).contiguous().to(dev)
    Xb = K.bucketize_cuda(torch.from_numpy(X).to(dev), cand)
    w = torch.from_numpy((rng.random(n) > 0.2).astype(np.float32)).to(dev)
    fw = torch.from_numpy(rng.uniform(0.5, 1.5, f).astype(np.float32)).to(dev)
    fw[f // 2] = 0.0                                          # zero weight
    g = [torch.from_numpy(rng.normal(size=(n, o)).astype(np.float32)).to(dev)
         for _ in range(2)]
    return (Xb, cand, fw, _weighted_rows(g[0], w), _weighted_rows(g[1], w),
            depth, b, o, score, min_data, oblivious)


@pytest.mark.parametrize("oblivious", [False, True])
@pytest.mark.parametrize("score", ["cosine", "l2"])
@pytest.mark.parametrize("n,f,depth,min_data", [(512, 4, 4, 0),
                                                (4096, 16, 4, 20),
                                                (700, 5, 3, 20),
                                                (300, 3, 1, 0),
                                                (1000, 6, 2, 0)])
def test_tree_build_matches_plain(cuda_device, oblivious, score, n, f, depth,
                                  min_data):
    """K6: the choices equal to the plain version's, the values within 1e-6
    of scale (the kernel repeats the plain version's summation order), and
    the same bits on two launches."""
    a = _tree_args(np.random.default_rng(n + depth), cuda_device, n, f,
                   depth, score, min_data, oblivious)
    before = K.launch_counts["tree_build"]
    got = K.tree_build_cuda(*a)
    again = K.tree_build_cuda(*a)
    want = K.tree_build_plain(*a, K._tree_tiling(n, f)[0])
    torch.cuda.synchronize()
    assert K.launch_counts["tree_build"] == before + 2
    for x, y in zip(got, again):
        assert torch.equal(x, y)
    for x, y in zip(got[:2], want[:2]):
        assert torch.equal(x, y)
    for x, y in zip(got[2:], want[2:]):
        fin = torch.isfinite(y)
        assert torch.equal(fin, torch.isfinite(x))
        assert torch.equal(x[~fin], y[~fin])
        err = (x[fin] - y[fin]).abs().max().item()
        assert err <= 1e-6 * y[fin].abs().max().item(), err


@pytest.mark.parametrize("n,f,o,depth,oblivious", [
    (1, 4, 3, 4, False),                 # fewer samples than a cluster
    (5, 4, 3, 4, True),
    (333, 4, 3, 3, False),               # N not a multiple of 32
    (700, 1, 3, 4, False),               # one feature
    (1000, 64, 3, 4, False),             # many features, global values
    (600, 64, 3, 4, True),
    (512, 4, 1, 4, False),               # O = 1
    (512, 4, 8, 4, True),                # O = 8
    (512, 4, 8, 2, False),
    (512, 4, 3, 1, True),
    (4096, 16, 3, 2, False),
    (512, 4, 26, 4, False),              # histograms in global scratch
    (300, 4, 26, 4, True),               # ... and the reduced rows
])
def test_tree_build_shapes(cuda_device, n, f, o, depth, oblivious):
    """K6 across its cluster plan (O = 26: the regions shared memory cannot
    hold in global scratch), with a fifth of the rows of zero weight:
    the choices equal to the plain version's at the plan's tile, the values
    within 1e-6 of scale, the same bits on three launches."""
    rng = np.random.default_rng(n * 7 + f + o + depth)
    a = _tree_args(rng, cuda_device, n, f, depth, "cosine", 0, oblivious,
                   o=o)
    runs = [K.tree_build_cuda(*a) for _ in range(3)]
    want = K.tree_build_plain(*a, K._tree_tiling(n, f)[0])
    torch.cuda.synchronize()
    for got in runs[1:]:
        for x, y in zip(got, runs[0]):
            assert torch.equal(x, y)
    got = runs[0]
    for x, y in zip(got[:2], want[:2]):
        assert torch.equal(x, y)
    for x, y in zip(got[2:], want[2:]):
        fin = torch.isfinite(y)
        assert torch.equal(fin, torch.isfinite(x))
        assert torch.equal(x[~fin], y[~fin])
        if fin.any():
            err = (x[fin] - y[fin]).abs().max().item()
            assert err <= 1e-6 * y[fin].abs().max().item(), err


def test_tree_build_rejects_bad_inputs(cuda_device):
    a = list(_tree_args(np.random.default_rng(0), cuda_device, 64, 3, 4,
                        "cosine", 0, False))
    with pytest.raises(ValueError, match="depths 1 to 4"):
        K.tree_build_cuda(*a[:5], 5, *a[6:])
    with pytest.raises(ValueError):
        K.tree_build_cuda(a[0].float(), *a[1:])
    with pytest.raises(ValueError):
        K.tree_build_cuda(*a[:3], a[3][:, :2].contiguous(), *a[4:])


class _FailingLibrary:
    """The built library with one entry point that reports a CUDA error."""

    def __init__(self, lib, failing: str):
        self._lib, self._failing = lib, failing

    def __getattr__(self, name):
        if name == self._failing:
            return lambda *args: 1                  # cudaErrorInvalidValue
        return getattr(self._lib, name)


@pytest.mark.parametrize("entry", ["gbrl_k1_bucketize",
                                   "gbrl_k2_level_histogram",
                                   "gbrl_k3_level_score",
                                   "gbrl_k6_tree_build",
                                   "gbrl_k4_leaf_sum", "gbrl_k5_leaf_sum"])
def test_failing_launch_raises_without_fallback(cuda_device, monkeypatch,
                                                entry):
    """A wrapper whose library call fails raises: it neither falls back to
    the plain version nor counts a launch (K1-K6)."""
    Xd, cd, nd = _fit_inputs(np.random.default_rng(0), cuda_device, 256, 4,
                             16, 2)
    Xb = K.bucketize_cuda(Xd, cd)
    hist = K.level_histogram_cuda(Xb, nd, 17)
    blocked = torch.zeros((2, 4, 16), dtype=torch.bool, device=cuda_device)
    fw = torch.ones(4, device=cuda_device)
    calls = {"gbrl_k1_bucketize": lambda: K.bucketize_cuda(Xd, cd),
             "gbrl_k2_level_histogram":
                 lambda: K.level_histogram_cuda(Xb, nd, 17),
             "gbrl_k3_level_score":
                 lambda: K.level_score_cuda(hist, blocked, fw, 16, 3,
                                            "cosine", 0, False, False),
             "gbrl_k6_tree_build":
                 lambda: K.tree_build_cuda(Xb, cd, fw, nd[:, :4].contiguous(),
                                           nd[:, :4].contiguous(), 2, 16, 3,
                                           "cosine", 0, False)}
    ens = [torch.from_numpy(a).to(cuda_device) for a in
           _ensemble(np.random.default_rng(1), True, 8, 4, 3, 3)]
    ntd = torch.tensor(8, dtype=torch.int32, device=cuda_device)
    calls["gbrl_k4_leaf_sum"] = lambda: K.weighted_leaf_sum_cuda(
        Xd, *ens, 3, ntd)
    calls["gbrl_k5_leaf_sum"] = lambda: K.oblivious_leaf_sum_cuda(
        Xd, *ens, 3, ntd)
    real = K._library()
    monkeypatch.setattr(K, "_library", lambda: _FailingLibrary(real, entry))
    before = dict(K.launch_counts)
    with pytest.raises(RuntimeError, match="CUDA error 1"):
        calls[entry]()
    assert K.launch_counts == before


@pytest.mark.parametrize("policy", ["greedy", "oblivious"])
def test_nccl_group_of_one_bit_equal(cuda_device, policy):
    """Supervised train and boost steps through an NCCL group of one
    (``parallel.sharded``) are bit-equal to the single-process card path:
    every field of the ensemble and every loss."""
    import socket
    import torch.distributed as dist
    from gbrl_tpu_torch.config import TreeConfig
    from gbrl_tpu_torch.ensemble import ensemble_to_numpy, init_ensemble
    from gbrl_tpu_torch.ops import boosting as BO
    from gbrl_tpu_torch.ops.loss import multirmse_grads
    from gbrl_tpu_torch.optimizers import OptimizerSpec
    from gbrl_tpu_torch.parallel import sharded
    rng = np.random.default_rng(3)
    N, F, O = 2048, 8, 3
    X, y, g = (torch.from_numpy(rng.normal(size=s).astype(np.float32)).to(
        cuda_device) for s in ((N, F), (N, O), (N, O)))
    cfg = TreeConfig(input_dim=F, output_dim=O, n_num_features=F,
                     max_depth=4, n_bins=64, grow_policy=policy,
                     split_score_func="l2", use_control_variates=True)
    specs = (OptimizerSpec(algo="SGD", init_lr=0.1, start_idx=0,
                           stop_idx=O),)
    fw, w = torch.ones(F, device=cuda_device), torch.ones(N, device=cuda_device)
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    dist.init_process_group("nccl", init_method=f"tcp://127.0.0.1:{port}",
                            world_size=1, rank=0)
    try:
        mesh = sharded.make_mesh(device=cuda_device)
        assert (mesh.world, mesh.backend) == (1, "nccl")
        a = b = init_ensemble(cfg, 16, "cuda")
        for step in range(8):
            if step < 6:
                a, la = sharded.sharded_train_step(cfg, mesh, a, X, y, fw,
                                                   specs)
                preds = BO.predict_sgd(cfg, b, X, specs, 0, b.n_trees)
                grads, lb = multirmse_grads(preds, y, w)
                b = BO.boost_step(cfg, b, X, grads, fw)
                assert torch.equal(la, lb), step
            else:
                a = sharded.sharded_boost_step(cfg, mesh, a, X, g, fw)
                b = BO.boost_step(cfg, b, X, g, fw)
        assert mesh.collectives > 0
    finally:
        dist.destroy_process_group()
    xa, xb = ensemble_to_numpy(a), ensemble_to_numpy(b)
    for k in xa:
        np.testing.assert_array_equal(xa[k], xb[k], err_msg=k)
