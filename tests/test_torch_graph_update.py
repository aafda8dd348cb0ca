"""The PPO update's one loop and its CUDA graphs (``rl/jit_update.py``,
``rl/graphs.py``) and the batched tree write (``ops/boosting.py``
``write_tree`` of U trees).

On the CPU: one ``write_tree`` of U trees against U sequential calls;
``ppo_update_loop``, which calls the minibatch body the card captures,
against a sequential yardstick written here, bit for bit; nothing is
captured off the card (no ``graph.*`` count), and the sharded loop gives
the same trees.  On the card (marked ``cuda``, skips without one): graph
replay against the same loop with ``graphs.run_step`` swapped for a plain
call, bit for bit, over two updates with a capacity growth between them,
partial minibatches and autoreset rows, on both tree paths, with the
capture, replay and launch counts.  Run the card tests on a machine with
an H100: ``python -m pytest tests/test_torch_graph_update.py -q -m cuda``."""
import contextlib

import numpy as np
import pytest
import torch

from gbrl_tpu_torch.config import TreeConfig
from gbrl_tpu_torch.ensemble import (ensemble_to_numpy, ensure_capacity,
                                     init_ensemble)
from gbrl_tpu_torch.ops import fit as FT
from gbrl_tpu_torch.ops import kernels as K
from gbrl_tpu_torch.ops.boosting import tree_prediction, write_tree
from gbrl_tpu_torch.ops.candidates import bucketize, numerical_candidates
from gbrl_tpu_torch.optimizers import OptimizerSpec
from gbrl_tpu_torch.parallel.sharded import Mesh
from gbrl_tpu_torch.parallel.sharded_rl import sharded_ppo_update
from gbrl_tpu_torch.rl import graphs as G
from gbrl_tpu_torch.rl import jit_update as JU
from gbrl_tpu_torch.utils import profiling

F, NA = 4, 2
GRAPH_COUNTS = ("graph.capture", "graph.replay", "graph.eager")


def _cfg(policy="greedy"):
    return TreeConfig(input_dim=F, output_dim=NA + 1, policy_dim=NA,
                      n_num_features=F, max_depth=4, n_bins=16,
                      grow_policy=policy, split_score_func="cosine")


SPECS = (OptimizerSpec(algo="SGD", init_lr=0.17, start_idx=0, stop_idx=NA),
         OptimizerSpec(algo="SGD", scheduler="Linear", init_lr=0.01,
                       stop_idx=NA + 1, start_idx=NA, T=20))
HP = JU.PPOHyper(n_actions=NA, clip_range=0.2, ent_coef=0.01, vf_coef=0.5,
                 normalize_advantage=True, policy_clip=2.0, value_clip=0.0)


def _update_inputs(seed: int, dev, n=300, epochs=2, batch=128):
    """One rollout of ``n`` rows (repeated values, a tenth autoreset rows)
    and its plan: minibatches of ``batch``, the last of each epoch
    partial."""
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n, F)).astype(np.float32)
    X[: n // 6, 1] = 0.5
    cols = [rng.integers(0, NA, n).astype(np.int64),
            rng.normal(scale=0.2, size=n).astype(np.float32) - 0.7,
            rng.normal(size=n).astype(np.float32),
            rng.normal(size=n).astype(np.float32),
            (rng.random(n) > 0.1).astype(np.float32)]
    mb_idx, mb_n = JU.minibatch_plan(n, epochs, batch, rng)
    t = [torch.from_numpy(a).to(dev) for a in [X, mb_idx] + cols]
    return t[0], t[1], mb_n.tolist(), t[2:6], t[6]


def _sequential(cfg, U: int, ens, X, plan, mb_n, actions, old_logp, adv,
                ret, fw, n_trees0: int, valid):
    """The yardstick: the update minibatch by minibatch from the host,
    ``ppo_minibatch_tree``, ``write_tree`` and ``tree_prediction`` each.
    Returns the ensemble, the entropies and the incremental
    predictions."""
    preds = JU.predict_sgd(cfg, ens, X, SPECS, 0, n_trees0)
    rows = torch.arange(plan.shape[1], device=X.device)
    ents = []
    for u in range(U):
        idx = plan[u]
        w = (rows < mb_n[u]).to(torch.float32)
        if valid is not None:
            w = w * valid[idx]
        tree, t_idx, ent = JU.ppo_minibatch_tree(
            cfg, HP, SPECS, fw, n_trees0 + u, mb_n[u], w, X[idx], preds[idx],
            actions[idx], old_logp[idx], adv[idx], ret[idx])
        ens = write_tree(ens, tree, t_idx)
        preds = preds + tree_prediction(cfg, SPECS, tree, t_idx, X)
        ents.append(ent)
    return ens, torch.stack(ents), preds


def _grown(cfg, dev, n_trees: int, capacity: int):
    """An ensemble with ``n_trees`` fitted trees in a capacity of
    ``capacity``."""
    ens = init_ensemble(cfg, capacity, str(dev))
    ens.bias[:] = torch.tensor([0.1, -0.2, 0.3])
    if n_trees:
        X, plan, mb_n, cols, valid = _update_inputs(99, dev)
        ens = _sequential(cfg, n_trees, ens, X, plan, mb_n, *cols,
                          torch.ones(F, device=dev), 0, valid)[0]
    return ens


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


def _random_trees(cfg, U: int, seed: int) -> list:
    """U trees fit on random rows (greedy or oblivious), as dicts."""
    rng = np.random.default_rng(seed)
    trees = []
    for _ in range(U):
        X = torch.from_numpy(rng.normal(size=(64, F)).astype(np.float32))
        g = torch.from_numpy(rng.normal(size=(64, NA + 1)).astype(np.float32))
        cand = numerical_candidates(cfg, X)
        trees.append(FT.build_tree(cfg, bucketize(X, cand), cand, g, g,
                                   torch.ones(64), torch.ones(F)))
    return trees


@pytest.mark.parametrize("policy,n_trees0,capacity", [
    ("greedy", 0, 8), ("greedy", 3, 4), ("oblivious", 0, 8),
    ("oblivious", 3, 4)])
def test_write_trees_equals_sequential_writes(policy, n_trees0, capacity):
    """One ``write_tree`` of U = 5 stacked trees at n_trees0 ... n_trees0 + 4
    gives the ensemble five single ``write_tree`` calls give, field by
    field; with a capacity of 4 the indices cross a capacity growth; the
    ensemble written into stays as it was."""
    cfg = _cfg(policy)
    U = 5
    ens = _grown(cfg, "cpu", n_trees0, capacity)
    ens = ensure_capacity(ens, n_trees0 + U)
    assert ens.capacity == (8 if capacity == 4 else capacity)
    before = ensemble_to_numpy(ens)
    trees = _random_trees(cfg, U, seed=n_trees0 + capacity)
    seq = ens
    for u, tree in enumerate(trees):
        seq = write_tree(seq, tree, torch.tensor(n_trees0 + u,
                                                 dtype=torch.int32))
    stacked = {k: torch.stack([t[k] for t in trees]) for k in trees[0]}
    idx = torch.arange(n_trees0, n_trees0 + U, dtype=torch.int32)
    batched = write_tree(ens, stacked, idx)
    _assert_same_ensemble(batched, seq)
    assert int(batched.n_trees) == n_trees0 + U
    for k, v in ensemble_to_numpy(ens).items():
        np.testing.assert_array_equal(v, before[k], err_msg=k)


@pytest.mark.parametrize("path,valid", [("level", True), ("level", False),
                                        ("k6", True)])
def test_graph_body_matches_eager_loop_on_cpu(path, valid):
    """``ppo_update_loop`` on CPU tensors, which calls the body the card
    captures minibatch by minibatch from its static buffers and device
    counters, then writes once: the sequential yardstick's ensemble,
    entropies and incremental predictions, bit for bit; the counters end
    at U; the ensemble loaded stays as it was."""
    cfg = _cfg()
    ens = ensure_capacity(_grown(cfg, "cpu", 3, 8), 3 + 6)
    X, plan, mb_n, cols, v = _update_inputs(5, "cpu")
    v = v if valid else None
    fw = torch.tensor([1.0, 0.5, 1.0, 2.0])
    U = len(mb_n)
    assert U == 6 and mb_n[2] == mb_n[5] == 44
    before = ensemble_to_numpy(ens)
    with _tree_path(path):
        want, want_ent, preds = _sequential(cfg, U, ens, X, plan, mb_n,
                                            *cols, fw, 3, v)
        got, ent = JU.ppo_update_loop(cfg, HP, U, ens, X, plan, mb_n, *cols,
                                      SPECS, fw, 3, v)
        g = JU._ppo_graphs(cfg, HP, SPECS, U, ens, X, plan, fw, valid)
    _assert_same_ensemble(got, want)
    assert torch.equal(ent, want_ent)
    assert int(g.u[0]) == U and int(g.t) == 3 + U
    assert torch.equal(g.preds, preds)
    for k, a in ensemble_to_numpy(ens).items():
        np.testing.assert_array_equal(a, before[k], err_msg=k)


@pytest.mark.parametrize("where", ["cpu", "mesh"])
def test_update_stays_eager_off_the_card(where, monkeypatch):
    """``ppo_update_loop`` on CPU tensors captures nothing: it takes one
    ``graphs.run_step`` a minibatch, which keeps no graph, and no
    ``graph.*`` count moves; the sharded loop over a mesh of one gives the
    same trees."""
    cfg = _cfg()
    ens = ensure_capacity(_grown(cfg, "cpu", 2, 8), 2 + 6)
    X, plan, mb_n, cols, v = _update_inputs(7, "cpu")
    fw = torch.ones(F)
    U = len(mb_n)
    calls = _spy_steps(monkeypatch)
    before = _graph_counts()
    want, want_ent = JU.ppo_update_loop(cfg, HP, U, ens, X, plan, mb_n,
                                        *cols, SPECS, fw, 2, v)
    if where == "mesh":
        got, ent = sharded_ppo_update(cfg, HP, Mesh(0, 1, torch.device("cpu")),
                                      ens, X, plan, mb_n, *cols, SPECS, fw,
                                      v, 2)
        _assert_same_ensemble(got, want)
        assert torch.equal(ent, want_ent)
    assert _delta(before) == dict.fromkeys(GRAPH_COUNTS, 0)
    assert calls == [("cpu", 0)] * U
    assert int(want.n_trees) == 2 + U


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: CUDA graphs and the CUDA kernels "
                    "run only on the card")
    return torch.device("cuda")


def _two_updates(cuda_device):
    """Two updates through ``ppo_update_loop`` from one ensemble of 3 trees
    in a capacity of 8; the second grows the capacity to 16.  Returns the
    ensembles, the entropy traces and each update's launch counts, and
    the ``graph.*`` counts of the two updates."""
    cfg = _cfg()
    ens = _grown(cfg, cuda_device, 3, 8)
    fw = torch.tensor([1.0, 0.5, 1.0, 2.0], device=cuda_device)
    before = _graph_counts()
    out = []
    nt = 3
    for seed in (11, 12):
        X, plan, mb_n, cols, v = _update_inputs(seed, cuda_device)
        U = len(mb_n)
        ens = ensure_capacity(ens, nt + U)
        K.reset_launch_counts()
        ens, ent = JU.ppo_update_loop(cfg, HP, U, ens, X, plan, mb_n, *cols,
                                      SPECS, fw, nt, v)
        torch.cuda.synchronize()
        out.append((ens, ent, dict(K.launch_counts)))
        nt += U
    assert out[1][0].capacity == 16 and int(out[1][0].n_trees) == 15
    return out, _delta(before)


@pytest.mark.cuda
@pytest.mark.parametrize("path", ["level", "k6"])
def test_graph_replay_matches_eager_on_card(cuda_device, path, monkeypatch):
    """Graph replay against the same loop with ``graphs.run_step`` swapped
    for a plain call, on the card, two updates of 6 minibatches (128, 128,
    44 rows an epoch; autoreset rows masked) with a capacity growth between
    them: the same ensembles, entropy traces and incremental predictions,
    bit for bit; one capture per key (128 and 44 rows), U replays in an
    update once captured, the plain calls' launch counts."""
    G._GRAPHS.clear()
    with _tree_path(path):
        with monkeypatch.context() as m:
            m.setattr(G, "run_step", _plain_step)
            plain, plain_counts = _two_updates(cuda_device)
        graph, counts = _two_updates(cuda_device)
    assert plain_counts == dict.fromkeys(GRAPH_COUNTS, 0), plain_counts
    assert counts == {"graph.capture": 2, "graph.eager": 2,
                      "graph.replay": 4 + 6}, counts
    for (ge, gent, gl), (ee, eent, el) in zip(graph, plain):
        _assert_same_ensemble(ge, ee)
        assert torch.equal(gent, eent)
        assert gl == el, (gl, el)
        fits = el["tree_build"] if path == "k6" else el["level_score"] // 4
        assert fits == el["bucketize"] == 6, el
    # the graphs' incremental predictions after the second update
    (g,) = G._GRAPHS.values()
    cfg, ens0 = _cfg(), plain[0][0]
    X = _update_inputs(12, cuda_device)[0]
    preds = JU.predict_sgd(cfg, ens0, X, SPECS, 0, 9)
    ens = plain[1][0]
    for u in range(6):
        tree = {k: getattr(ens, k)[9 + u] for k in
                ("feat", "thr", "cat_code", "is_split", "is_numeric",
                 "leaf_values")}
        preds = preds + tree_prediction(
            cfg, SPECS, tree, torch.tensor(9 + u, dtype=torch.int32,
                                           device=cuda_device), X)
    assert torch.equal(g.preds, preds)
