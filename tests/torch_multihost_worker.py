"""Worker process for tests/test_torch_parallel.py (the PyTorch port's
counterpart of tests/multihost_worker.py; it imports torch and numpy only).

Run as: python torch_multihost_worker.py <out_dir>
with torchrun's MASTER_ADDR / MASTER_PORT / WORLD_SIZE / RANK set.  Joins
the 2-rank gloo group through ``hosts.initialize`` (CPU tensors), then from
its OWN shard of each dataset only:

- the supervised steps of tests/multihost_worker.py (6 train steps, 2
  boost steps) for each configuration in ``SUPERVISED``;
- one PPO update phase on the data of tests/test_parallel_rl.py ``_setup``
  on each tree path, and one AWR update phase (examples/multihost_awr.py's
  trees);
- the errors: K6 with samples sharded over two ranks, uneven shards;
- rank 0 alone, on a gloo group of one, each of the four sharded steps and
  its non-distributed counterpart, for a bit-for-bit comparison.

Everything lands in <out_dir>/rank<r>.npz.
"""
import os
import sys

import numpy as np

SUPERVISED = {
    "cosine": dict(grow_policy="greedy", split_score_func="cosine"),
    "l2_cv": dict(grow_policy="greedy", split_score_func="l2",
                  use_control_variates=True),
    "oblivious_uniform": dict(grow_policy="oblivious",
                              split_score_func="cosine",
                              generator_type="uniform"),
    "categorical": dict(grow_policy="greedy", split_score_func="cosine"),
}
N_CAT, N_CODES = 3, 8
TRAIN_STEPS, BOOST_STEPS = 6, 2
AWR_KC, AWR_KA = 8, 4


def supervised_data():
    """tests/multihost_worker.py's dataset (the same draws), plus three
    categorical columns that move the targets."""
    rng = np.random.default_rng(7)
    N, F, O = 512, 6, 2
    X = rng.normal(size=(N, F)).astype(np.float32)
    W = rng.normal(size=(F, O)).astype(np.float32)
    y = (X @ W).astype(np.float32)
    g = rng.normal(size=(N, O)).astype(np.float32)
    Xc = rng.integers(0, 5, size=(N, N_CAT)).astype(np.int32)
    y_cat = (y + 1.5 * (Xc[:, :1] == 2) - (Xc[:, 1:2] == 0)).astype(np.float32)
    return X, y, g, Xc, y_cat


def supervised_config(name: str, tree_config):
    F, O = 6, 2
    n_cat = N_CAT if name == "categorical" else 0
    return tree_config(input_dim=F + n_cat, output_dim=O, n_num_features=F,
                       n_cat_features=n_cat, max_depth=3, n_bins=8,
                       **SUPERVISED[name])


def ppo_data(tree_config, optimizer_spec, ppo_hyper):
    """tests/test_parallel_rl.py ``_setup`` (B = 256, F = 6, 3 actions,
    depth 3, 16 bins, U = 8 minibatches of 64), the same draws."""
    B, F, na, depth = 256, 6, 3, 3
    cfg = tree_config(input_dim=F, output_dim=na + 1, policy_dim=na,
                      n_num_features=F, max_depth=depth, n_bins=16,
                      grow_policy="greedy", split_score_func="cosine")
    specs = (optimizer_spec(algo="SGD", init_lr=0.1, start_idx=0,
                            stop_idx=na),
             optimizer_spec(algo="SGD", init_lr=0.05, start_idx=na,
                            stop_idx=na + 1))
    hp = ppo_hyper(n_actions=na, clip_range=0.2, ent_coef=0.01, vf_coef=0.5,
                   normalize_advantage=True, policy_clip=0.0, value_clip=0.0)
    rng = np.random.default_rng(0)
    X = rng.normal(size=(B, F)).astype(np.float32)
    actions = rng.integers(0, na, B).astype(np.int32)
    old_logp = np.full(B, -np.log(na), np.float32)
    adv = rng.normal(size=B).astype(np.float32)
    ret = rng.normal(size=B).astype(np.float32)
    U, mb = 8, 64
    mb_idx = np.stack([rng.permutation(B)[:mb] for _ in range(U)]
                      ).astype(np.int32)
    mb_n = np.full(U, mb, np.int32)
    return cfg, specs, hp, X, actions, old_logp, adv, ret, mb_idx, mb_n


def awr_data(tree_config, optimizer_spec, awr_hyper):
    """An AWR replay with examples/multihost_awr.py's trees (oblivious,
    depth 3, 32 bins, cosine; F = 3, A = 1), 256 rows, 8 critic and 4
    actor minibatches of 64."""
    B, F, A, mb = 256, 3, 1, 64
    kw = dict(input_dim=F, n_num_features=F, max_depth=3, n_bins=32,
              grow_policy="oblivious", split_score_func="cosine")
    acfg = tree_config(output_dim=A, **kw)
    ccfg = tree_config(output_dim=1, **kw)
    specs = ((optimizer_spec(algo="SGD", init_lr=0.05, start_idx=0,
                             stop_idx=A),),
             (optimizer_spec(algo="SGD", init_lr=0.1, start_idx=0,
                             stop_idx=1),))
    hp = awr_hyper(act_dim=A, beta=0.5, max_weight=20.0, learn_std=False,
                   log_std_init=-0.5, grad_clip=10.0)
    rng = np.random.default_rng(5)
    X = rng.normal(size=(B, F)).astype(np.float32)
    acts = np.clip(rng.normal(size=(B, A)), -2, 2).astype(np.float32)
    rets = rng.normal(size=B).astype(np.float32)
    advs = rng.normal(size=B).astype(np.float32)
    cmb = rng.integers(0, B, (AWR_KC, mb)).astype(np.int32)
    amb = rng.integers(0, B, (AWR_KA, mb)).astype(np.int32)
    return acfg, ccfg, specs, hp, X, acts, rets, advs, cmb, amb


def _arrays(prefix: str, ens) -> dict:
    from gbrl_tpu_torch.ensemble import ensemble_to_numpy
    return {f"{prefix}_{k}": v for k, v in ensemble_to_numpy(ens).items()}


def _equal(a, b) -> bool:
    from gbrl_tpu_torch.ensemble import ensemble_to_numpy
    x, y = ensemble_to_numpy(a), ensemble_to_numpy(b)
    return all(np.array_equal(x[k], y[k], equal_nan=True) for k in x)


def _raises(fn) -> str:
    try:
        fn()
    except ValueError as e:
        return str(e)
    return ""


def main(out_dir: str) -> None:
    import torch
    import torch.distributed as dist
    torch.set_num_threads(1)
    from gbrl_tpu_torch.config import TreeConfig
    from gbrl_tpu_torch.ensemble import init_ensemble
    from gbrl_tpu_torch.ops import fit as FT
    from gbrl_tpu_torch.optimizers import OptimizerSpec
    from gbrl_tpu_torch.parallel import hosts, sharded
    from gbrl_tpu_torch.rl.jit_awr import AWRHyper
    from gbrl_tpu_torch.rl.jit_update import PPOHyper

    hosts.initialize(device="cpu")          # torchrun's variables
    hosts.initialize(device="cpu")          # a second call does nothing
    mesh = hosts.global_mesh()
    rank, W = mesh.rank, mesh.world
    out = dict(rank=rank, world=W, backend=mesh.backend)
    # a gloo group of one per rank: the world-of-1 cases run through it
    solos = [dist.new_group([r]) for r in range(W)]
    solo = sharded.make_mesh(solos[rank], "cpu")
    # the exact bits of every rank's row, -0.0 and NaN included, and a sum
    # in rank order
    special = torch.tensor([-0.0, float("nan"), rank + 0.5, 1e-45])
    out["gather_bits"] = mesh.gather_ranks(special).numpy()
    out["sum_ranks"] = mesh.sum_ranks(torch.tensor([0.1, 1e8]) * (rank + 1)
                                      ).numpy()

    X, y, g, Xc, y_cat = supervised_data()
    N, F = X.shape
    lo, hi = rank * (N // W), (rank + 1) * (N // W)
    fw = np.ones(F, np.float32)
    for name in SUPERVISED:
        cfg = supervised_config(name, TreeConfig)
        specs = (OptimizerSpec(algo="SGD", init_lr=0.2, start_idx=0,
                               stop_idx=2),)
        ens = hosts.replicate(mesh, init_ensemble(cfg, 16, "cpu"))
        losses = []
        if name == "categorical":
            cat = dict(Xc=sharded.shard_batch(mesh, Xc),
                       feat_w_cat=torch.ones(N_CAT), n_codes=N_CODES)
            Xs = sharded.shard_batch(mesh, X)
            for _ in range(TRAIN_STEPS):
                ens, loss = sharded.sharded_train_step(
                    cfg, mesh, ens, Xs, sharded.shard_batch(mesh, y_cat),
                    torch.ones(F), specs, **cat)
                losses.append(float(loss))
            for _ in range(BOOST_STEPS):
                ens = sharded.sharded_boost_step(
                    cfg, mesh, ens, Xs, sharded.shard_batch(mesh, g),
                    torch.ones(F), **cat)
        else:
            for _ in range(TRAIN_STEPS):
                ens, loss = hosts.host_train_step(cfg, mesh, ens, X[lo:hi],
                                                  y[lo:hi], fw, specs)
                losses.append(float(loss))
            for _ in range(BOOST_STEPS):
                ens = hosts.host_boost_step(cfg, mesh, ens, X[lo:hi],
                                            g[lo:hi], fw)
        out.update(_arrays(f"sup_{name}", ens))
        out[f"sup_{name}_losses"] = np.array(losses, np.float64)

    # PPO on both tree paths, rollout sharded
    cfg, specs, hp, Xr, acts, old_lp, adv, ret, mb_idx, mb_n = ppo_data(
        TreeConfig, OptimizerSpec, PPOHyper)
    B = Xr.shape[0]
    plo, phi = rank * (B // W), (rank + 1) * (B // W)
    for path in ("level", "k6"):
        FT._DISABLE_FUSED_TREE = path == "level"
        pens = hosts.replicate(mesh, init_ensemble(cfg, 16, "cpu"))
        pens, ent = hosts.host_ppo_update(
            cfg, hp, mesh, pens, Xr[plo:phi], mb_idx, mb_n, acts[plo:phi],
            old_lp[plo:phi], adv[plo:phi], ret[plo:phi], specs, fw)
        out.update(_arrays(f"ppo_{path}", pens))
        out[f"ppo_{path}_ent"] = ent.numpy()
    FT._DISABLE_FUSED_TREE = True

    # AWR, replay sharded
    acfg, ccfg, aspecs, ahp, Xa, aa, ar, aadv, cmb, amb = awr_data(
        TreeConfig, OptimizerSpec, AWRHyper)
    Ba = Xa.shape[0]
    alo, ahi = rank * (Ba // W), (rank + 1) * (Ba // W)
    aens, cens, (ctr, atr) = hosts.host_awr_update(
        acfg, ccfg, ahp, mesh, init_ensemble(acfg, 16, "cpu"),
        init_ensemble(ccfg, 16, "cpu"), Xa[alo:ahi], aa[alo:ahi],
        ar[alo:ahi], aadv[alo:ahi], cmb, amb, aspecs, fw[:3])
    out.update(_arrays("awr_actor", aens))
    out.update(_arrays("awr_critic", cens))
    out["awr_traces"] = np.concatenate([ctr.numpy(), atr.numpy()])

    # errors: K6 with samples sharded over both ranks; uneven shards
    cfg0 = supervised_config("cosine", TreeConfig)
    FT._DISABLE_FUSED_TREE = False
    out["err_k6"] = _raises(lambda: hosts.host_boost_step(
        cfg0, mesh, init_ensemble(cfg0, 4, "cpu"), X[lo:hi], g[lo:hi], fw))
    FT._DISABLE_FUSED_TREE = True
    out["err_uneven"] = _raises(
        lambda: hosts.host_array(mesh, X[: 10 + 2 * rank]))

    if rank == 0:
        out.update(_world_of_one(solo))
    out["collectives"] = mesh.collectives
    np.savez(os.path.join(out_dir, f"rank{rank}.npz"), **out)
    hosts.shutdown()


def _world_of_one(solo) -> dict:
    """Each sharded step on a gloo group of one against its
    non-distributed counterpart: True where every field, loss and trace is
    equal bit for bit."""
    import torch
    from gbrl_tpu_torch.config import TreeConfig
    from gbrl_tpu_torch.ensemble import init_ensemble
    from gbrl_tpu_torch.ops import boosting as BO
    from gbrl_tpu_torch.ops.loss import multirmse_grads
    from gbrl_tpu_torch.optimizers import OptimizerSpec
    from gbrl_tpu_torch.parallel import sharded, sharded_rl
    from gbrl_tpu_torch.rl.jit_awr import AWRHyper, awr_update_loop
    from gbrl_tpu_torch.rl.jit_update import PPOHyper, ppo_update_loop

    res = {}
    X, y, g, _, _ = supervised_data()
    Xt, yt, gt = (torch.from_numpy(a) for a in (X, y, g))
    fw = torch.ones(X.shape[1])
    specs = (OptimizerSpec(algo="SGD", init_lr=0.2, start_idx=0,
                           stop_idx=2),)
    for name in ("cosine", "l2_cv", "oblivious_uniform"):
        cfg = supervised_config(name, TreeConfig)
        a = b = init_ensemble(cfg, 16, "cpu")
        same = True
        for _ in range(3):
            a = sharded.sharded_boost_step(cfg, solo, a, Xt, gt, fw)
            b = BO.boost_step(cfg, b, Xt, gt, fw)
            same &= _equal(a, b)
        res[f"solo_boost_{name}"] = same
        same = True
        for _ in range(3):
            a, la = sharded.sharded_train_step(cfg, solo, a, Xt, yt, fw,
                                               specs)
            preds = BO.predict_sgd(cfg, b, Xt, specs, 0, b.n_trees)
            grads, lb = multirmse_grads(preds, yt, torch.ones(X.shape[0]))
            b = BO.boost_step(cfg, b, Xt, grads, fw)
            same &= _equal(a, b) and torch.equal(la, lb)
        res[f"solo_train_{name}"] = same

    cfg, specs, hp, Xr, acts, old_lp, adv, ret, mb_idx, mb_n = ppo_data(
        TreeConfig, OptimizerSpec, PPOHyper)
    t = [torch.from_numpy(v) for v in (Xr, acts.astype(np.int64), old_lp,
                                        adv, ret)]
    fwr = torch.ones(Xr.shape[1])
    valid = torch.from_numpy((np.arange(len(Xr)) % 7 != 3).astype(np.float32))
    for label, v in (("", None), ("_valid", valid)):
        a, ea = sharded_rl.sharded_ppo_update(
            cfg, hp, solo, init_ensemble(cfg, 16, "cpu"), t[0], mb_idx,
            mb_n, *t[1:], specs, fwr, v, 0)
        b, eb = ppo_update_loop(
            cfg, hp, len(mb_n), init_ensemble(cfg, 16, "cpu"), t[0],
            torch.from_numpy(mb_idx.astype(np.int64)), mb_n.tolist(), *t[1:],
            specs, fwr, 0, v)
        res[f"solo_ppo{label}"] = _equal(a, b) and torch.equal(ea, eb)

    acfg, ccfg, aspecs, ahp, Xa, aa, ar, aadv, cmb, amb = awr_data(
        TreeConfig, OptimizerSpec, AWRHyper)
    ta = [torch.from_numpy(v) for v in (Xa, aa, ar, aadv)]
    plans = [torch.from_numpy(p.astype(np.int64)) for p in (cmb, amb)]

    def fresh():
        return init_ensemble(acfg, 16, "cpu"), init_ensemble(ccfg, 16, "cpu")
    a1, c1, tr1 = sharded_rl.sharded_awr_update(
        acfg, ccfg, ahp, solo, *fresh(), *ta, *plans, aspecs, torch.ones(3))
    a2, c2, tr2 = awr_update_loop(acfg, ccfg, ahp, aspecs, (AWR_KC, AWR_KA),
                                  *fresh(), *ta, *plans, torch.ones(3))
    res["solo_awr"] = (_equal(a1, a2) and _equal(c1, c2)
                       and all(torch.equal(x, z) for x, z in zip(tr1, tr2)))
    res["solo_collectives"] = solo.collectives
    return res


if __name__ == "__main__":
    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    main(sys.argv[1])
