"""The cluster kernels' launch plans, checked on the CPU for every shape the
card tests and ``chip_smoke.py`` give them.  K2 (``ops.kernels._hist_plan``):
the slices and the blocks' shares of them cover every (feature, column,
bucket) exactly once, the sample tiles cover every sample once, and each
block stays within the shared-memory budget, the portable cluster size and
the grid's limits (the index arithmetic repeats ``level_hist_kernel``'s,
``csrc/fit.cu``).  K3 (``_score_plan``) and K6 (``_tree_plan``): the work
each rank owns, as ``level_score_kernel`` and ``tree_build_kernel`` index
it."""
import numpy as np
import pytest
import torch

from gbrl_tpu_torch.ops import kernels as K

SHAPES = ([(4096, 16, c, 257) for c in (4, 8, 16, 32)]       # bench levels
          + [(512, 4, c, 257) for c in (4, 8, 16, 32)]       # PPO minibatch
          + [(10, 3, 8, 9), (33, 3, 8, 257), (777, 5, 16, 1025),
             (1000, 300, 8, 257), (4096, 16, 1, 257), (100, 4, 4, 1),
             (1000, 4, 24, 257), (300, 2, 4, 100_000)])      # bucket ranges


def _coverage(plan: K.HistPlan, F: int, C: int, NB: int) -> np.ndarray:
    """How often the kernel writes each out[f, c, b] under ``plan``."""
    S, fs, cs, br = plan.S, plan.fs, plan.cs, plan.br
    hw = -(-(fs * cs * br) // 4) * 4
    q4 = hw // 4
    per = -(-q4 // S)
    hits = np.zeros((F, C, NB), np.int64)
    for bx in range(plan.grid[0]):
        f0, rank = (bx // S) * fs, bx % S
        nfs = min(fs, F - f0)
        flat = np.arange(4 * rank * per, 4 * min(q4, rank * per + per))
        j, rem = np.divmod(flat, cs * br)
        c, bl = np.divmod(rem, br)
        for by in range(plan.grid[1]):
            c0 = by * cs
            ncs = min(cs, C - c0)
            for bz in range(plan.grid[2]):
                b0 = bz * br
                nbr = min(br, NB - b0)
                ok = (j < nfs) & (c < ncs) & (bl < nbr)
                np.add.at(hits, (f0 + j[ok], c0 + c[ok], b0 + bl[ok]), 1)
    return hits


@pytest.mark.parametrize("N,F,C,NB", SHAPES)
def test_hist_plan_covers_each_bin_once(N, F, C, NB):
    plan = K._hist_plan(N, F, C, NB)
    assert plan.smem == K._hist_smem(plan.fs, plan.cs, plan.br)
    assert plan.smem <= K.HIST_SMEM_BUDGET
    assert plan.S in (1, 2, 4, 8) and plan.S <= K.HIST_MAX_CLUSTER
    assert plan.grid[0] % plan.S == 0
    assert max(plan.grid[1:]) <= 65535
    assert K.HIST_SUB <= 1 << 16              # u16 sample lists
    # every sample in exactly one rank's tile, each tile at least
    # HIST_MIN_TILE samples once the cluster has grown
    starts = np.arange(plan.S) * plan.tile
    seen = np.zeros(N, np.int64)
    for s in starts:
        seen[s:min(N, s + plan.tile)] += 1
    assert (seen == 1).all()
    assert plan.S == 1 or plan.tile >= K.HIST_MIN_TILE
    assert (_coverage(plan, F, C, NB) == 1).all()


def test_hist_plan_depends_on_shapes_only():
    """The main-path shapes take one cluster plan each: eight blocks per
    slice, one feature per warp, every bucket in one slice."""
    for N, C in ((4096, 32), (512, 4)):
        plan = K._hist_plan(N, 16 if N == 4096 else 4, C, 257)
        assert (plan.S, plan.fs, plan.br) == (8, 4, 257)
        assert plan == K._hist_plan(N, 16 if N == 4096 else 4, C, 257)


# ------------------------------------------------------------------ K3
SCORE_SHAPES = [(4, 1, 3, False), (4, 8, 3, False), (4, 8, 3, True),
                (16, 1, 3, False), (16, 8, 3, True), (300, 1, 3, False),
                (300, 8, 3, True), (16, 16, 3, False), (16, 512, 3, False),
                (16, 8, 1, False), (16, 8, 8, True), (5, 2, 8, False),
                (1, 1, 3, False), (16, 64, 3, True), (16, 8, 224, False),
                (3000, 2, 3, False), (40, 2048, 20, True),
                # wide O: the staged rows in global scratch
                (16, 8, 256, False), (16, 8, 256, True), (16, 1, 300, False),
                (16, 8, 300, True), (4, 8, 300, False), (300, 2, 256, True)]


@pytest.mark.parametrize("F,n_nodes,O,oblivious", SCORE_SHAPES)
def test_score_plan_covers_each_node_feature_once(F, n_nodes, O, oblivious):
    """K3's plan: the clusters, ranks, feature groups and node chunks of
    level_score_kernel (csrc/fit.cu) visit every (node, feature) exactly
    once per pass; blocks own contiguous features in rank order, so the
    first index of the lowest rank with a hit is the level's; the staged
    rows go to global scratch (one (node, feature) at a time, one slice per
    block) exactly where even the smallest shared plan exceeds the budget,
    and shared memory then holds only what does not grow with the rows."""
    B = 256
    plan = K._score_plan(F, n_nodes, O, B, oblivious)
    S, fpb, g, nc = plan.S, plan.fpb, plan.g, plan.nc
    assert 1 <= S <= K.SCORE_MAX_CLUSTER and (S - 1) * fpb < F <= S * fpb
    NS = n_nodes if oblivious else 1
    units = 1 if oblivious else n_nodes       # clusters: fit.cu k3_config
    assert plan.smem == 4 * K._score_words(B + 1, O + 1, B, NS, fpb, g, nc,
                                           plan.keep, plan.fuse, plan.glob)
    smallest = 4 * K._score_words(B + 1, O + 1, B, NS, fpb, 1, 1, 0, 0)
    assert plan.glob == (smallest > K.SCORE_SMEM_BUDGET)
    if plan.glob:
        assert (g, nc, plan.fuse) == (1, 1, 0)
        assert plan.scratch == units * S * (O + 1) * ((B + 1) | 1)
        # past the budget only with what shared memory must hold regardless
        assert (plan.smem <= K.SCORE_SMEM_BUDGET
                or 4 * (NS * (O + 2) + 36) > K.SCORE_SMEM_BUDGET)
    else:
        assert plan.scratch == 0 and plan.smem <= K.SCORE_SMEM_BUDGET
    hits = np.zeros((n_nodes, F), np.int64)
    starts = []
    for bx in range(units * S):
        unit, rank = divmod(bx, S)
        node0 = 0 if oblivious else unit
        fa, fb = rank * fpb, min(F, rank * fpb + fpb)
        assert fa < fb
        if unit == 0:
            starts.append(fa)
        for ga in range(fa, fb, g):
            for c0 in range(0, NS, nc):
                nodes = node0 + np.arange(c0, min(NS, c0 + nc))
                hits[np.ix_(nodes, np.arange(ga, min(fb, ga + g)))] += 1
    assert (hits == 1).all()
    assert starts == sorted(starts)


@pytest.mark.parametrize("oblivious", [False, True])
def test_score_plan_argmax_composes(oblivious):
    """The plan's argmax, emulated: each rank's max and first hit over its
    own features, then the cluster's max and the lowest rank's hit, equals
    the plain version's choice on the same candidate values."""
    rng = np.random.default_rng(3)
    F, n_nodes, O, B = 13, 4, 3, 16
    Xb = torch.from_numpy(rng.integers(0, B + 1, (500, F)).astype(np.int32))
    nd = torch.from_numpy(rng.normal(size=(500, n_nodes * (O + 1)))
                          .astype(np.float32))
    hist = K.level_histogram_plain(Xb, nd, B + 1)
    blocked = torch.from_numpy(rng.random((n_nodes, F, B)) < 0.3)
    fw = torch.ones(F)
    args = (hist, blocked, fw, B, O, "cosine", 0, oblivious, False)
    rows, scale, *_ = K.level_score_rows(*args)
    want = K.level_score_plain(*args)
    plan = K._score_plan(F, n_nodes, O, B, oblivious)
    for r_i, row in enumerate(rows):
        row = row.numpy()
        parts = [row[r * plan.fpb * B:min(F, (r + 1) * plan.fpb) * B]
                 for r in range(plan.S)]
        m = max(p.max() for p in parts)
        sc = float(scale.reshape(-1)[r_i]) if scale.dim() else 0.0
        tol = np.float32((abs(m) + np.float32(sc)) * np.float32(2e-6)) \
            if np.isfinite(m) else np.float32(0)
        lim = np.float32(m - tol)
        q = next(r * plan.fpb * B + int(np.argmax(p >= lim))
                 for r, p in enumerate(parts) if (p >= lim).any())
        assert q == int(want[0][r_i])


# ------------------------------------------------------------------ K6
TREE_SHAPES = [(n, f, o, d, obl) for n, f, o, d in (
    (512, 4, 3, 4), (4096, 16, 3, 4), (1, 4, 3, 4), (5, 4, 3, 4),
    (333, 4, 3, 3), (700, 1, 3, 4), (1000, 64, 3, 4), (600, 64, 3, 4),
    (512, 4, 1, 4), (512, 4, 8, 4), (512, 4, 8, 2), (512, 4, 3, 1),
    (4096, 16, 3, 2), (700, 5, 3, 3), (300, 3, 3, 1), (1000, 6, 3, 2),
    (64, 3, 3, 4), (256, 4, 3, 4), (512, 4, 26, 4), (300, 4, 26, 4))
    for obl in (False, True)]


@pytest.mark.parametrize("N,F,O,D,oblivious", TREE_SHAPES)
def test_tree_plan_covers_each_sample_and_unit_once(N, F, O, D, oblivious):
    """K6's plan for every shape of the card tests and chip_smoke.py: the
    ranks' tiles cover every sample once in rank order (the plain version's
    tiles); at every level the groups and the ranks' round-robin units cover
    each (feature, node) once, within the reduced rows and candidate slots
    the layout holds; the regions do not overlap; the block fits the
    budget and the cluster limit."""
    B, KO = 256, O + 1
    plan = K._tree_plan(N, F, O, B, D, oblivious)
    S, tile = plan.S, plan.tile
    assert S in (1, 2, 4, 8, 16) and S <= K.TREE_MAX_CLUSTER
    assert (tile, -(-N // tile)) == K._tree_tiling(N, F)
    seen = np.zeros(N, np.int64)
    last = -1
    for r in range(S):
        lo, hi = min(N, r * tile), min(N, r * tile + tile)
        seen[lo:hi] += 1
        assert lo >= last
        last = hi
    assert (seen == 1).all()
    assert S == 1 or tile >= K.TREE_MIN_TILE
    assert plan.smem <= K.TREE_SMEM_BUDGET
    offs = list(plan.offsets)
    assert offs == sorted(offs) and 4 * offs[-1] < plan.smem
    sizes = dict(zip(K.TREE_REGIONS, np.diff(offs + [plan.smem // 4])))
    NBp = (B + 1) | 1
    for d in range(D):
        nact, g = 1 << d, plan.g[d]
        Cd = nact * KO
        assert 1 <= g <= min(F, K.TREE_MAX_GROUP)
        assert g * Cd * -(-(B + 1) // 4) * 4 <= (
            plan.part if plan.part_global else sizes["part"])
        nu = 1 if oblivious else nact
        ru = (nact if oblivious else 1) * KO
        hits = np.zeros((F, nact), np.int64)
        slots = np.zeros(S, np.int64)
        for ga in range(0, F, g):
            U = min(g, F - ga) * nu
            for r in range(S):
                own = [u for u in range(r, U, S)]
                assert len(own) * ru * NBp <= (
                    plan.red if plan.red_global else sizes["red"])
                slots[r] += len(own)
                for u in own:
                    j = u // nu
                    nodes = range(nact) if oblivious else [u % nu]
                    for node in nodes:
                        hits[ga + j, node] += 1
        assert (hits == 1).all()
        assert slots.max() <= plan.slots
    if not plan.sc_global:
        assert plan.slots * B <= sizes["sc"]
    glob = [(n, on) for n, on in ((plan.slots * B, plan.sc_global),
                                  (plan.part, plan.part_global),
                                  (plan.red, plan.red_global))]
    assert plan.scratch >= S * sum(n for n, on in glob if on)
    # a region goes to global memory only when shared memory cannot hold it
    assert plan.part_global <= (KO >= 20)
    assert 2 * plan.slots <= sizes["slot"]
    assert K.TREE_SUB * (plan.gmax | 1) <= sizes["xb"]
    assert K.TREE_SUB * (KO | 1) <= sizes["v"]
    assert K.TREE_LEAVES * K.TREE_SUB <= 2 * sizes["list"]


# --------------------------------------------------------------- K4 / K5
# (N, F, T_cap, depth, O): the serving, PPO-rollout and A2C shapes, the
# card tests' grid corners, chip_smoke.py's dispatch cases, deep trees and
# wide F / O past the shared-memory budget
PREDICT_SHAPES = [(4096, 16, 2048, 4, 3), (4096, 16, 1024, 4, 3),
                  (1024, 4, 1024, 4, 3), (1, 16, 2048, 4, 3),
                  (1000, 16, 256, 4, 3), (37, 5, 16, 3, 11),
                  (100, 300, 64, 6, 2), (300, 16, 24, 10, 3),
                  (64, 4, 8, 2, 2), (4096, 300, 512, 4, 3),
                  (4096, 16, 512, 8, 3), (4096, 16, 512, 11, 3),
                  (4, 16, 8, 12, 3), (1000, 1, 129, 1, 19),
                  (4096, 16, 2048, 8, 8), (1000, 16, 64, 4, 2000),
                  (0, 4, 0, 3, 2), (33, 3, 7, 9, 1), (2048, 16, 512, 4, 3),
                  (2049, 16, 512, 4, 3), (1000, 16, 64, 9, 8)]


def _rank_trees(plan, rank: int, T: int) -> list:
    """The trees rank ``rank`` walks, in order, as predict.cu's tree_at and
    rank_trees give them (every tree live): its chunks c = rank, rank + S,
    ... in order, each chunk's trees in order."""
    chunk, S = plan.chunk, plan.S
    chunks = -(-T // chunk)
    mine = -(-(chunks - rank) // S) if chunks > rank else 0
    last = mine and (chunks - 1) % S == rank
    n = mine * chunk - (chunks * chunk - T if last else 0)
    return [(rank + (q // chunk) * S) * chunk + q % chunk for q in range(n)]


def _staged_trees(plan, rank: int, T: int) -> list:
    """The same trees as the staged instance loads them, ``sb`` positions a
    stage."""
    seq = _rank_trees(plan, rank, T)
    return [t for q0 in range(0, len(seq), plan.sb)
            for t in seq[q0:q0 + plan.sb]]


@pytest.mark.parametrize("oblivious", [False, True])
@pytest.mark.parametrize("N,F,T,D,O", PREDICT_SHAPES)
def test_predict_plan_covers_each_tile_and_chunk_once(N, F, T, D, O,
                                                      oblivious):
    """K4/K5's plan: every (sample tile, tree) pair is walked by exactly one
    block, each rank's trees in increasing order and in whole chunks of
    chunk c -> rank c % S, for every n_trees; the staged and the global
    routes walk the same sequence; the cluster size and chunk (which fix
    every add) come from (N, T_cap) alone, so K4 and K5 share them; each
    region fits its block."""
    plan = K._predict_plan(N, F, T, D, O, oblivious)
    other = K._predict_plan(N, F, T, D, O, not oblivious)
    assert (plan.S, plan.groups, plan.chunk) == (other.S, other.groups,
                                                 other.chunk)
    G = plan.groups
    assert G == K._predict_groups(N, O) and G in (1, K.PREDICT_GROUPS)
    assert plan.S == K._predict_ranks(N, T, G)
    assert plan.S in (1, 2, 4, 8, 16) and plan.chunk == K.PREDICT_CHUNK
    if G > 1:        # small N: one block of warp groups a tile, no cluster
        assert plan.S == 1 and plan.tile == K.PREDICT_MIN_TILE
        assert N <= K.PREDICT_SPLIT_N and O <= K.PREDICT_OREG
        assert K.PREDICT_GROUP % G == 0    # a stage starts at a multiple
    assert plan.tile * G <= K.PREDICT_MAX_TILE
    assert plan.tile % 32 == 0
    assert K.PREDICT_MIN_TILE <= plan.tile <= K.PREDICT_MAX_TILE
    tiles = -(-N // plan.tile)
    assert plan.grid == tiles * plan.S
    if plan.staged:
        assert K.PREDICT_GROUP <= plan.sb <= K.PREDICT_STAGE
        assert D <= K.PREDICT_MAX_STAGED_DEPTH
        assert plan.smem <= K.PREDICT_SMEM_BUDGET
        KN = D if oblivious else (1 << D) - 1
        assert plan.buf >= plan.sb * (8 * KN + 4 * (1 << D) * O)
        assert plan.ring_off >= 4 * F * plan.tile
    for nt in sorted({T, T // 2, min(T, 129), min(T, 1), 0}):
        hits = np.zeros((tiles, nt), np.int64)
        for rank in range(plan.S):
            seq = _rank_trees(plan, rank, nt)
            assert seq == sorted(seq)
            if plan.staged:
                assert _staged_trees(plan, rank, nt) == seq
            assert all((t // plan.chunk) % plan.S == rank for t in seq)
            # the groups split the rank's positions, each in order
            parts = [seq[g::G] for g in range(G)]
            assert sorted(sum(parts, [])) == seq
            for ti in range(tiles):
                for part in parts:
                    hits[ti, part] += 1
        assert (hits == 1).all()
    red = G if G > 1 else int(plan.S > 1 or O > K.PREDICT_OREG)
    if plan.red_global:
        assert red and 4 * O * plan.tile > K.PREDICT_SMEM_BUDGET
        assert plan.scratch == plan.grid * O * plan.tile
    else:
        assert plan.smem - plan.red_off == 4 * O * plan.tile * red


@pytest.mark.parametrize("oblivious", [False, True])
@pytest.mark.parametrize("N,F,T,D,O", PREDICT_SHAPES)
def test_predict_plan_global_exactly_where_a_group_does_not_fit(
        N, F, T, D, O, oblivious):
    """The global route is taken exactly where no tile (from the largest
    down to PREDICT_MIN_TILE) holds X's tile and two buffers of a group of
    PREDICT_GROUP trees within the budget, or past the staged depths; the
    plan is a pure function of the shapes."""
    KN = D if oblivious else (1 << D) - 1
    G = K._predict_groups(N, O)
    red = G if G > 1 else int(K._predict_ranks(N, T, G) > 1
                              or O > K.PREDICT_OREG)
    top = (K.PREDICT_MIN_TILE if G > 1 else min(
        K.PREDICT_MAX_TILE, max(K.PREDICT_MIN_TILE, -(-N // 32) * 32)))
    tiles = [top >> k for k in range(8) if top >> k >= K.PREDICT_MIN_TILE]
    group = [4 * F * t + 2 * K.PREDICT_GROUP * (8 * KN + 4 * (1 << D) * O)
             + 4 * O * t * red for t in tiles]
    fits = (D <= K.PREDICT_MAX_STAGED_DEPTH
            and min(group) <= K.PREDICT_SMEM_BUDGET)
    plan = K._predict_plan(N, F, T, D, O, oblivious)
    assert plan.staged == fits
    assert plan == K._predict_plan.__wrapped__(N, F, T, D, O, oblivious)


def test_predict_plan_main_shapes():
    """The serving and PPO-rollout shapes stage X and 16 trees a buffer in
    blocks of 256 samples, 16 ranks a cluster; A2C (N = 1024) takes blocks
    of 32 samples x 8 warp groups and no cluster; depth 11 and 12 at
    F = 16 and O = 3 take the global route."""
    for N, F, T, obl in ((4096, 16, 2048, False), (4096, 16, 2048, True),
                         (4096, 4, 1024, False)):
        plan = K._predict_plan(N, F, T, 4, 3, obl)
        assert (plan.S, plan.groups, plan.tile, plan.staged, plan.sb) == (
            16, 1, 256, 1, 16)
    plan = K._predict_plan(1024, 4, 1024, 4, 3, True)
    assert (plan.S, plan.groups, plan.tile, plan.staged, plan.sb,
            plan.grid) == (1, 8, 32, 1, 32, 32)
    for D in (11, 12):
        assert not K._predict_plan(4096, 16, 512, D, 3, False).staged
