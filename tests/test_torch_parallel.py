"""The port's data-parallel layer (gbrl_tpu_torch/parallel) on the CPU: two
gloo ranks spawned once (tests/torch_multihost_worker.py, one PyTorch thread
each) run every case from their own shards; here their ensembles are held
against each other (bit-identical), against ``gbrl_tpu``'s sharded or
single-device results and the port's own single-process loops (the
tolerances of tests/test_multihost.py:101-113 and
tests/test_parallel_rl.py:70-74), and a world of 1 against the
non-distributed path (bit for bit).

    python -m pytest tests/test_torch_parallel.py -q
"""
import os
import socket
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gbrl_tpu.config import TreeConfig as JTreeConfig
from gbrl_tpu.ensemble import ensemble_to_numpy as j_ensemble_to_numpy
from gbrl_tpu.ensemble import init_ensemble as j_init_ensemble
from gbrl_tpu.ops import boosting as jboost
from gbrl_tpu.ops.loss import multirmse_grads as j_multirmse_grads
from gbrl_tpu.optimizers import OptimizerSpec as JOptimizerSpec
from gbrl_tpu.parallel import hosts as jhosts
from gbrl_tpu.parallel import sharded as jsharded
from gbrl_tpu.rl.jit_awr import AWRHyper as JAWRHyper
from gbrl_tpu.rl.jit_awr import awr_update_loop as j_awr_update_loop
from gbrl_tpu.rl.jit_update import PPOHyper as JPPOHyper
from gbrl_tpu.rl.jit_update import ppo_update_loop as j_ppo_update_loop

import torch_multihost_worker as W
from gbrl_tpu_torch.config import TreeConfig
from gbrl_tpu_torch.ensemble import (ensemble_from_numpy, ensemble_to_numpy,
                                     init_ensemble)
from gbrl_tpu_torch.ops import fit as FT
from gbrl_tpu_torch.optimizers import OptimizerSpec
from gbrl_tpu_torch.parallel import hosts, sharded
from gbrl_tpu_torch.rl.jit_awr import AWRHyper, awr_update_loop
from gbrl_tpu_torch.rl.jit_update import PPOHyper, ppo_update_loop

WORKER = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                      "torch_multihost_worker.py")
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIELDS = ("feat", "thr", "is_split", "leaf_values", "n_trees")
DATASETS = ["sup_" + n for n in W.SUPERVISED] + ["ppo_level", "ppo_k6",
                                                  "awr_actor", "awr_critic"]
SOLO_CASES = ([f"solo_{s}_{n}" for s in ("boost", "train")
               for n in ("cosine", "l2_cv", "oblivious_uniform")]
              + ["solo_ppo", "solo_ppo_valid", "solo_awr"])


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """Both ranks' outputs, from one spawn of two gloo processes."""
    d = tmp_path_factory.mktemp("torch_multihost")
    port = _free_port()
    procs = []
    for rank in range(2):
        env = dict(os.environ, MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port),
                   WORLD_SIZE="2", RANK=str(rank), OMP_NUM_THREADS="1",
                   PYTHONPATH=REPO)
        procs.append(subprocess.Popen(
            [sys.executable, WORKER, str(d)], env=env,
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT))
    logs = [p.communicate(timeout=300)[0].decode() for p in procs]
    for p, log in zip(procs, logs):
        assert p.returncode == 0, f"rank failed:\n{log[-3000:]}"
    return [dict(np.load(d / f"rank{r}.npz")) for r in range(2)]


def _ens(out: dict, prefix: str) -> dict:
    return {k: out[f"{prefix}_{k}"] for k in FIELDS}


def _assert_trees_close(got: dict, want: dict, n: int, thr_tol: dict,
                        leaf_tol: dict) -> None:
    assert int(got["n_trees"]) == int(want["n_trees"]) == n
    np.testing.assert_array_equal(got["feat"][:n], np.asarray(want["feat"])[:n])
    np.testing.assert_array_equal(got["is_split"][:n],
                                  np.asarray(want["is_split"])[:n])
    np.testing.assert_allclose(got["thr"][:n], np.asarray(want["thr"])[:n],
                               **thr_tol)
    np.testing.assert_allclose(got["leaf_values"][:n],
                               np.asarray(want["leaf_values"])[:n], **leaf_tol)


# tests/test_multihost.py:101-113 and tests/test_parallel_rl.py:70-74
SUP_THR, SUP_LEAF = dict(rtol=1e-6, atol=1e-7), dict(rtol=1e-5, atol=1e-6)
RL_THR, RL_LEAF = dict(rtol=0, atol=0), dict(rtol=1e-5, atol=1e-6)


def test_initialize_reads_torchrun_env(ranks):
    for r, out in enumerate(ranks):
        assert (int(out["rank"]), int(out["world"]), str(out["backend"])) \
            == (r, 2, "gloo")


def test_gather_is_exact_and_sum_in_rank_order(ranks):
    for out in ranks:
        bits = out["gather_bits"].view(np.uint32)
        want = np.array([[-0.0, np.nan, 0.5, 1e-45],
                         [-0.0, np.nan, 1.5, 1e-45]], np.float32)
        np.testing.assert_array_equal(bits, want.view(np.uint32))
        parts = np.array([0.1, 1e8], np.float32)
        np.testing.assert_array_equal(out["sum_ranks"],
                                      parts * np.float32(1) + parts * 2)
    assert int(ranks[0]["collectives"]) == int(ranks[1]["collectives"])


@pytest.mark.parametrize("prefix", DATASETS)
def test_ranks_bit_identical(ranks, prefix):
    a, b = ranks
    keys = [k for k in a if k.startswith(prefix + "_")]
    assert len(keys) >= 10
    for k in keys:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    if prefix == "awr_actor":
        np.testing.assert_array_equal(a["awr_traces"], b["awr_traces"])


@pytest.mark.parametrize("case", SOLO_CASES)
def test_world_of_one_is_bit_identity(ranks, case):
    """A gloo group of one against the non-distributed port: boost_step;
    predict -> multirmse_grads -> boost_step; ppo_update_loop (with and
    without a valid mask); awr_update_loop."""
    assert bool(ranks[0][case]), f"{case}: a world of 1 changed the bits"
    assert int(ranks[0]["solo_collectives"]) > 0


def test_mesh_without_group_is_identity():
    mesh = sharded.make_mesh(device="cpu")
    assert (mesh.rank, mesh.world, mesh.group) == (0, 1, None)
    t = torch.tensor([[-0.0, 1.0], [2.0, float("nan")]])
    bits = t.view(torch.int32)
    assert torch.equal(mesh.sum_ranks(t).view(torch.int32), bits)
    assert torch.equal(mesh.gather_ranks(t)[0].view(torch.int32), bits)
    x = np.arange(6, dtype=np.float32).reshape(3, 2)
    np.testing.assert_array_equal(sharded.shard_batch(mesh, x).numpy(), x)
    rep = sharded.replicate(mesh, init_ensemble(TreeConfig(), 4, "cpu"))
    assert rep.feat.shape == (4, 15) and mesh.collectives == 0


def test_hosts_replicate_on_one_rank():
    """hosts.replicate on a world of 1: an ensemble and a feature-weight
    array arrive on the rank's device equal to what gbrl_tpu's
    hosts.replicate places on a one-device mesh; they are copies, and no
    collective runs.  It is sharded.replicate: the package has one
    replicate path, rank 0's values broadcast."""
    assert hosts.replicate is sharded.replicate
    mesh = sharded.make_mesh(device="cpu")
    jmesh = jsharded.make_mesh(1)
    cfg = W.supervised_config("cosine", JTreeConfig)
    jens = j_init_ensemble(cfg, capacity=8)
    jens = jens.replace(thr=jnp.asarray(np.random.default_rng(4).normal(
        size=jens.thr.shape).astype(np.float32)))
    ens = ensemble_from_numpy(j_ensemble_to_numpy(jens), device="cpu")
    fw = np.linspace(0.5, 2.0, 4).astype(np.float32)
    got = hosts.replicate(mesh, ens)
    want = j_ensemble_to_numpy(jhosts.replicate(jmesh, jens))
    for f, v in ensemble_to_numpy(got).items():
        assert getattr(got, f).device == mesh.device
        np.testing.assert_array_equal(v, want[f])
    assert got.thr.data_ptr() != ens.thr.data_ptr()
    t = torch.from_numpy(fw)
    for arr in (fw, t):
        got_fw = hosts.replicate(mesh, arr)
        assert got_fw.device == mesh.device
        assert got_fw.data_ptr() != t.data_ptr()
        np.testing.assert_array_equal(got_fw.numpy(),
                                      np.asarray(jhosts.replicate(jmesh, fw)))
    assert mesh.collectives == 0


def _j_cfg(name: str) -> JTreeConfig:
    return W.supervised_config(name, JTreeConfig)


@pytest.mark.parametrize("name", list(W.SUPERVISED))
def test_supervised_matches_jax(ranks, name):
    """Two ranks' train and boost steps against gbrl_tpu's
    ``sharded_train_step`` / ``sharded_boost_step`` on a 2-device mesh
    (single-device ``boost_step`` with categorical columns, which the JAX
    sharded steps do not take)."""
    X, y, g, Xc, y_cat = W.supervised_data()
    cfg = _j_cfg(name)
    specs = (JOptimizerSpec(algo="SGD", init_lr=0.2, start_idx=0,
                            stop_idx=2),)
    fw = jnp.ones(X.shape[1], jnp.float32)
    ens = j_init_ensemble(cfg, capacity=16)
    losses = []
    if name == "categorical":
        cat = (jnp.asarray(Xc), jnp.ones(W.N_CAT, jnp.float32), W.N_CODES)

        @jax.jit
        def train(e):
            p = jboost.predict_sgd(cfg, e, jnp.asarray(X), specs, 0,
                                   e.n_trees, cat[0])
            gr, loss = j_multirmse_grads(p, jnp.asarray(y_cat),
                                         jnp.ones(X.shape[0], jnp.float32))
            return jboost.boost_step(cfg, e, jnp.asarray(X), gr, fw,
                                     *cat), loss
        boost = jax.jit(lambda e: jboost.boost_step(
            cfg, e, jnp.asarray(X), jnp.asarray(g), fw, *cat))
    else:
        mesh = jsharded.make_mesh(2)

        def train(e):
            return jsharded.sharded_train_step(cfg, mesh, e, jnp.asarray(X),
                                               jnp.asarray(y), fw, specs)

        def boost(e):
            return jsharded.sharded_boost_step(cfg, mesh, e, jnp.asarray(X),
                                               jnp.asarray(g), fw)
    for _ in range(W.TRAIN_STEPS):
        ens, loss = train(ens)
        losses.append(float(loss))
    for _ in range(W.BOOST_STEPS):
        ens = boost(ens)
    n = W.TRAIN_STEPS + W.BOOST_STEPS
    got = _ens(ranks[0], f"sup_{name}")
    _assert_trees_close(got, j_ensemble_to_numpy(ens), n, SUP_THR, SUP_LEAF)
    np.testing.assert_allclose(ranks[0][f"sup_{name}_losses"], losses,
                               rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("path", ["level", "k6"])
def test_ppo_matches_jax_and_port(ranks, path):
    """``host_ppo_update`` over two ranks against gbrl_tpu's single-device
    ``ppo_update_loop`` (its level path) and the port's own loop on the
    same tree path."""
    cfg, specs, hp, X, acts, old_lp, adv, ret, mb_idx, mb_n = W.ppo_data(
        TreeConfig, OptimizerSpec, PPOHyper)
    got = _ens(ranks[0], f"ppo_{path}")
    U = len(mb_n)
    jcfg, jspecs, jhp = W.ppo_data(JTreeConfig, JOptimizerSpec, JPPOHyper)[:3]
    jens, _ = j_ppo_update_loop(
        jcfg, jhp, U, j_init_ensemble(jcfg, capacity=16), jnp.asarray(X),
        jnp.asarray(mb_idx), jnp.asarray(mb_n), jnp.asarray(acts),
        jnp.asarray(old_lp), jnp.asarray(adv), jnp.asarray(ret), jspecs,
        jnp.ones(X.shape[1], jnp.float32))
    _assert_trees_close(got, j_ensemble_to_numpy(jens), U, RL_THR, RL_LEAF)
    FT._DISABLE_FUSED_TREE = path == "level"
    try:
        t = [torch.from_numpy(v) for v in (X, acts.astype(np.int64), old_lp,
                                            adv, ret)]
        pens, ent = ppo_update_loop(
            cfg, hp, U, init_ensemble(cfg, 16, "cpu"), t[0],
            torch.from_numpy(mb_idx.astype(np.int64)), mb_n.tolist(),
            *t[1:], specs, torch.ones(X.shape[1]), 0)
    finally:
        FT._DISABLE_FUSED_TREE = True
    _assert_trees_close(got, ensemble_to_numpy(pens), U, RL_THR, RL_LEAF)
    np.testing.assert_allclose(ranks[0][f"ppo_{path}_ent"], ent.numpy(),
                               rtol=1e-5, atol=1e-6)


def test_awr_matches_jax_and_port(ranks):
    """``host_awr_update`` over two ranks against gbrl_tpu's
    ``awr_update_loop`` and the port's own."""
    acfg, ccfg, specs, hp, X, acts, rets, advs, cmb, amb = W.awr_data(
        TreeConfig, OptimizerSpec, AWRHyper)
    jacfg, jccfg, jspecs, jhp = W.awr_data(JTreeConfig, JOptimizerSpec,
                                           JAWRHyper)[:4]
    ja, jc, _ = j_awr_update_loop(
        jacfg, jccfg, jhp, jspecs, (W.AWR_KC, W.AWR_KA),
        j_init_ensemble(jacfg, capacity=16),
        j_init_ensemble(jccfg, capacity=16), jnp.asarray(X),
        jnp.asarray(acts), jnp.asarray(rets), jnp.asarray(advs),
        jnp.asarray(cmb), jnp.asarray(amb), jnp.ones(3, jnp.float32))
    pa, pc, _ = awr_update_loop(
        acfg, ccfg, hp, specs, (W.AWR_KC, W.AWR_KA),
        init_ensemble(acfg, 16, "cpu"), init_ensemble(ccfg, 16, "cpu"),
        *(torch.from_numpy(v) for v in (X, acts, rets, advs)),
        *(torch.from_numpy(p.astype(np.int64)) for p in (cmb, amb)),
        torch.ones(3))
    for role, n, jens, pens in (("actor", W.AWR_KA, ja, pa),
                                ("critic", W.AWR_KC, jc, pc)):
        got = _ens(ranks[0], f"awr_{role}")
        _assert_trees_close(got, j_ensemble_to_numpy(jens), n, RL_THR, RL_LEAF)
        _assert_trees_close(got, ensemble_to_numpy(pens), n, RL_THR, RL_LEAF)


def test_k6_with_sharded_samples_raises(ranks):
    for out in ranks:
        assert "whole-tree path (K6)" in str(out["err_k6"])


def test_uneven_shards_raise(ranks):
    for out in ranks:
        assert "[10, 12] rows" in str(out["err_uneven"])


def test_initialize_needs_an_address(monkeypatch):
    for name in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK"):
        monkeypatch.delenv(name, raising=False)
    with pytest.raises(ValueError, match="MASTER_ADDR"):
        hosts.initialize(device="cpu")
    with pytest.raises(ValueError, match="WORLD_SIZE"):
        hosts.initialize("127.0.0.1:1", device="cpu")
    assert not torch.distributed.is_initialized()


def test_cuda_without_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        hosts.initialize("127.0.0.1:1", 1, 0, device="cuda")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        sharded.make_mesh()
    assert not torch.distributed.is_initialized()
