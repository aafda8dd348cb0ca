"""The AWR update's one loop and its CUDA graphs (``rl/jit_awr.py``
``_AWRGraphs``, ``rl/graphs.py``).

On the CPU: ``awr_update_loop``, which calls the critic and actor step
bodies the card captures from their static buffers, working copies and
device counters, against a sequential yardstick of ``awr_critic_step`` /
``awr_actor_step``, bit for bit, over two updates whose replays differ in
length and are shorter than the buffers; the graph sets' keys (one set
for any learner of the same shapes and capacities); nothing is captured
off the card (no ``graph.*`` count), and the sharded loop gives the same
trees.  On the card (marked ``cuda``, skips without one): graph replay
against the same loop with ``graphs.run_step`` swapped for a plain call,
bit for bit, over two updates of one learner pair with a growing replay
and a third after a capacity growth (a second ``learn``), on both tree
paths, with the capture, replay and launch counts.  Run the card tests on
a machine with an H100:
``python -m pytest tests/test_torch_graph_awr.py -q -m cuda``."""
import contextlib

import numpy as np
import pytest
import torch

from gbrl_tpu_torch.config import TreeConfig
from gbrl_tpu_torch.ensemble import (ensemble_to_numpy, ensure_capacity,
                                     init_ensemble)
from gbrl_tpu_torch.ops import fit as FT
from gbrl_tpu_torch.ops import kernels as K
from gbrl_tpu_torch.optimizers import OptimizerSpec
from gbrl_tpu_torch.parallel.sharded import Mesh
from gbrl_tpu_torch.parallel.sharded_rl import sharded_awr_update
from gbrl_tpu_torch.rl import graphs as G
from gbrl_tpu_torch.rl import jit_awr as JA
from gbrl_tpu_torch.utils import profiling

F, A, MB, KC, KA, ROWS = 3, 1, 128, 3, 2, 600
GRAPH_COUNTS = ("graph.capture", "graph.replay", "graph.eager")


def _setup(learn_std: bool = False):
    """(actor cfg, critic cfg, hyper, specs): oblivious depth-4 trees of 16
    bins at F = 3, A = 1, the actor's log sigma learned or fixed."""
    kw = dict(input_dim=F, n_num_features=F, max_depth=4, n_bins=16,
              grow_policy="oblivious", split_score_func="cosine")
    O = 2 * A if learn_std else A
    acfg = TreeConfig(output_dim=O, **kw)
    ccfg = TreeConfig(output_dim=1, **kw)
    specs = ((OptimizerSpec(algo="SGD", init_lr=0.05, start_idx=0,
                            stop_idx=O),),
             (OptimizerSpec(algo="SGD", scheduler="Linear", init_lr=0.1,
                            start_idx=0, stop_idx=1, T=40),))
    hp = JA.AWRHyper(act_dim=A, beta=0.5, max_weight=20.0,
                     learn_std=learn_std, grad_clip=1.5)
    return acfg, ccfg, hp, specs


def _replay(seed: int, dev, B: int):
    """A replay of ``B`` rows (a column with repeated values) and its
    plans, KC and KA minibatches of MB rows drawn below B."""
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(B, F)).astype(np.float32)
    X[: B // 6, 2] = 0.5
    cols = [X, np.clip(rng.normal(size=(B, A)), -2, 2).astype(np.float32),
            (rng.normal(size=B) * 30 - 200).astype(np.float32),
            (rng.normal(size=B) * 5).astype(np.float32),
            rng.integers(0, B, (KC, MB)), rng.integers(0, B, (KA, MB))]
    return [torch.from_numpy(c).to(dev) for c in cols]


def _sequential(setup, actor, critic, X, acts, rets, advs, cmb, amb, fw):
    """The yardstick: the update step by step from the host,
    ``awr_critic_step`` for each critic plan row, then ``awr_actor_step``
    for each actor row.  Returns (actor, critic, (critic trace, actor
    trace))."""
    acfg, ccfg, hp, specs = setup
    ctrace, atrace = [], []
    for idx in cmb:
        critic, loss = JA.awr_critic_step(ccfg, specs[1], critic, fw, X[idx],
                                          rets[idx])
        ctrace.append(loss)
    for idx in amb:
        actor, loss = JA.awr_actor_step(acfg, hp, specs[0], actor, fw,
                                        X[idx], acts[idx], advs[idx])
        atrace.append(loss)
    return actor, critic, (torch.stack(ctrace), torch.stack(atrace))


def _grown(setup, dev, capacity: int = 16):
    """The actor's and the critic's ensembles after one update of 3 and 2
    trees from biases, in a capacity of ``capacity``."""
    acfg, ccfg, hp, specs = setup
    ens = []
    for cfg, bias in ((acfg, -0.3), (ccfg, -180.0)):
        e = init_ensemble(cfg, capacity, str(dev))
        e.bias[:] = bias
        ens.append(e)
    a, c, _ = _sequential(setup, *ens, *_replay(99, dev, 200),
                          torch.ones(F, device=dev))
    return a, c


def _plain_step(graphs, key, dev, body):
    """``graphs.run_step`` without a capture: the body, called."""
    body()


def _spy_steps(monkeypatch) -> list:
    """Wrap ``graphs.run_step``: a list of each call's device type and the
    size of its ``graphs`` dict after the call."""
    calls = []
    real = G.run_step

    def spy(graphs, key, dev, body):
        real(graphs, key, dev, body)
        calls.append((dev.type, len(graphs)))
    monkeypatch.setattr(G, "run_step", spy)
    return calls


@contextlib.contextmanager
def _tree_path(path: str):
    FT._DISABLE_FUSED_TREE = path != "k6"
    try:
        yield
    finally:
        FT._DISABLE_FUSED_TREE = True


def _graph_counts() -> dict:
    c = profiling.counters()
    return {k: c.get(k, 0) for k in GRAPH_COUNTS}


def _delta(before: dict) -> dict:
    return {k: n - before[k] for k, n in _graph_counts().items()}


def _assert_same_ensemble(a, b):
    a, b = ensemble_to_numpy(a), ensemble_to_numpy(b)
    for k in a:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def _assert_same_update(got, want):
    """Two (actor, critic, (critic trace, actor trace)) results: equal
    bits."""
    _assert_same_ensemble(got[0], want[0])
    _assert_same_ensemble(got[1], want[1])
    for x, y in zip(got[2], want[2]):
        assert torch.equal(x, y)


@pytest.mark.parametrize("path,learn_std", [("level", False),
                                            ("level", True),
                                            ("k6", False)])
def test_awr_graph_bodies_match_eager_loop_on_cpu(path, learn_std):
    """``awr_update_loop`` on CPU tensors, which calls the bodies the card
    captures step by step from one set of static buffers, over two updates
    (replays of 300 and 450 rows in buffers of 600): the sequential
    yardstick's ensembles and loss traces, bit for bit; the counters end
    at KC and KA; the ensembles loaded stay as they were (learner copies
    share them)."""
    setup = _setup(learn_std)
    acfg, ccfg, hp, specs = setup
    fw = torch.tensor([1.0, 0.5, 2.0])
    want = _grown(setup, "cpu")
    got = want
    g = None
    with _tree_path(path):
        for seed, B in ((1, 300), (2, 450)):
            X, acts, rets, advs, cmb, amb = _replay(seed, "cpu", B)
            before = [ensemble_to_numpy(e) for e in got[:2]]
            want = _sequential(setup, *want[:2], X, acts, rets, advs, cmb,
                               amb, fw)
            loaded, got = got, JA.awr_update_loop(
                acfg, ccfg, hp, specs, (KC, KA), *got[:2], X, acts, rets,
                advs, cmb, amb, fw, rows=ROWS)
            used = JA._awr_graphs(acfg, ccfg, hp, specs, (KC, KA),
                                  *loaded[:2], X, acts, cmb, amb, fw, ROWS)
            assert g is None or used is g
            g = used
            _assert_same_update(got, want)
            assert int(g.uc[0]) == KC and int(g.ua[0]) == KA
            for ens, arrs in zip(loaded[:2], before):
                for k, v in ensemble_to_numpy(ens).items():
                    np.testing.assert_array_equal(v, arrs[k], err_msg=k)
    assert int(got[0].n_trees) == 2 * KA + KA
    assert int(got[1].n_trees) == 2 * KC + KC


@pytest.mark.parametrize("where", ["cpu", "mesh"])
def test_awr_update_stays_eager_off_the_card(where, monkeypatch):
    """``awr_update_loop`` on CPU tensors captures nothing: it takes one
    ``graphs.run_step`` a step, which keeps no graph, and no ``graph.*``
    count moves; the sharded loop over a mesh of one gives the same trees
    and traces."""
    setup = _setup()
    acfg, ccfg, hp, specs = setup
    actor, critic = _grown(setup, "cpu")
    X, acts, rets, advs, cmb, amb = _replay(3, "cpu", 300)
    fw = torch.ones(F)
    calls = _spy_steps(monkeypatch)
    before = _graph_counts()
    want = JA.awr_update_loop(acfg, ccfg, hp, specs, (KC, KA), actor,
                              critic, X, acts, rets, advs, cmb, amb, fw,
                              rows=ROWS)
    if where == "mesh":
        got = sharded_awr_update(acfg, ccfg, hp,
                                 Mesh(0, 1, torch.device("cpu")), actor,
                                 critic, X, acts, rets, advs, cmb, amb,
                                 specs, fw)
        _assert_same_update(got, want)
    assert _delta(before) == dict.fromkeys(GRAPH_COUNTS, 0)
    assert calls == [("cpu", 0)] * (KC + KA)
    assert int(want[1].n_trees) == 2 * KC


def test_awr_graph_sets_are_keyed_by_shapes_not_learners():
    """One graph set serves any learner pair of the same configuration and
    capacities and any replay up to ``rows``; a new capacity, the other
    tree path or other buffer rows get a set of their own."""
    setup = _setup()
    acfg, ccfg, hp, specs = setup
    fw = torch.ones(F)

    def graphs(ens, B=300, rows=ROWS):
        X, acts, _, _, cmb, amb = _replay(4, "cpu", B)
        return JA._awr_graphs(acfg, ccfg, hp, specs, (KC, KA), *ens, X,
                              acts, cmb, amb, fw, rows)

    G._GRAPHS.clear()
    first = _grown(setup, "cpu")
    g = graphs(first)
    assert graphs(_grown(setup, "cpu")) is g
    assert graphs(first, B=ROWS) is g
    wider = [ensure_capacity(e, 17) for e in first]
    others = [graphs(wider), graphs(first, rows=2 * ROWS)]
    with _tree_path("k6"):
        others.append(graphs(first))
    assert len({id(x) for x in [g] + others}) == 4
    assert len(G._GRAPHS) == 4
    assert g.X.shape == (ROWS, F) and others[1].X.shape == (2 * ROWS, F)
    assert others[0].critic.capacity == 32
    G._GRAPHS.clear()


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: CUDA graphs and the CUDA kernels "
                    "run only on the card")
    return torch.device("cuda")


def _three_updates(dev):
    """Three updates through ``awr_update_loop`` from one learner pair:
    replays of 300, 450 and 500 rows in buffers of 600; before the third the
    capacities grow from 16 to 32 (a second ``learn``).  Returns each
    update's result and launch counts, and the ``graph.*`` counts."""
    setup = _setup()
    acfg, ccfg, hp, specs = setup
    fw = torch.tensor([1.0, 0.5, 2.0], device=dev)
    ens = _grown(setup, dev)
    before = _graph_counts()
    out = []
    for seed, B in ((1, 300), (2, 450), (3, 500)):
        if seed == 3:
            ens = [ensure_capacity(e, 17) for e in ens]
        K.reset_launch_counts()
        res = JA.awr_update_loop(acfg, ccfg, hp, specs, (KC, KA), *ens,
                                 *_replay(seed, dev, B), fw, rows=ROWS)
        torch.cuda.synchronize()
        out.append((res, dict(K.launch_counts)))
        ens = res[:2]
    assert ens[1].capacity == 32 and int(ens[1].n_trees) == 4 * KC
    return out, _delta(before)


@pytest.mark.cuda
@pytest.mark.parametrize("path", ["level", "k6"])
def test_awr_graph_replay_matches_eager_on_card(cuda_device, path,
                                                monkeypatch):
    """Graph replay against the same loop with ``graphs.run_step`` swapped
    for a plain call, on the card, over three updates (a growing replay,
    then a capacity growth): the same ensembles and loss traces, bit for
    bit; one capture per learner and capacity, a replay for every other
    step; the plain calls' launch counts, K5 once a tree."""
    G._GRAPHS.clear()
    with _tree_path(path):
        with monkeypatch.context() as m:
            m.setattr(G, "run_step", _plain_step)
            plain, plain_counts = _three_updates(cuda_device)
        graph, counts = _three_updates(cuda_device)
    steps = 3 * (KC + KA)
    assert plain_counts == dict.fromkeys(GRAPH_COUNTS, 0), plain_counts
    assert counts == {"graph.capture": 4, "graph.eager": 4,
                      "graph.replay": steps - 4}, counts
    for (gres, gl), (pres, pl) in zip(graph, plain):
        _assert_same_update(gres, pres)
        assert gl == pl, (gl, pl)
        fits = pl["tree_build"] if path == "k6" else pl["level_score"] // 4
        assert fits == pl["bucketize"] == pl["oblivious_leaf_sum"] \
            == KC + KA, pl
    assert len(G._GRAPHS) == 2
    G._GRAPHS.clear()
