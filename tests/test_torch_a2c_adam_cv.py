"""A2C with an Adam policy, an SGD value and control variates, against the
plain reference of the benchmark's ``a2c_cartpole.train`` cell
(``bench_port/reference/a2c.py``, float64, nothing of the program), on the
CPU at small sizes: the host mirror's Adam forward and the device
predict's ``adam_delta`` on seeded random oblivious ensembles, one fused
update's corrected gradients and tree, ``A2C.learn``'s spans and counters
and its numbers against the loop it was split from, and the cell's check
on a short unit, a planted fault on each side.

Tolerances: the program sums in float32, the reference in float64:
predictions within 2e-5 of their scale, gradients within 1e-4, the trees'
splits equal and their leaves within 1e-4."""
import json
import time

import numpy as np
import pytest
import torch

from bench_port import envs, harness
from bench_port.reference import a2c as R
from bench_port.reference import trees as RT
from bench_port.traffic import learn as L
from gbrl_tpu_torch.learners.actor_critic_learner import \
    SharedActorCriticLearner
from gbrl_tpu_torch.rl import A2C
from gbrl_tpu_torch.rl import jit_a2c
from gbrl_tpu_torch.utils import profiling
from gbrl_tpu_torch.utils.host_mirror import HostMirror

CFG = json.loads((harness.HERE / "configs" / "a2c_cartpole.json").read_text())
F, A, O, D = CFG["obs_dim"], CFG["n_actions"], CFG["output_dim"], 4
CELL = "a2c_cartpole.train"


@pytest.fixture(autouse=True)
def one_thread():
    """One intra-op thread: the runner's workers share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _learner(n_trees: int, seed: int, capacity: int = 64):
    """A learner of the cell's optimizers whose first ``n_trees`` trees are
    random oblivious trees of depth 4 over F features, with a random
    bias (zeros without trees)."""
    h = CFG["hyper"]
    lr = SharedActorCriticLearner(
        F, O, dict(CFG["tree_struct"]),
        dict(algo="Adam", init_lr=h["policy_lr"], start_idx=0, stop_idx=A),
        dict(algo="SGD", init_lr=h["value_lr"], start_idx=A, stop_idx=O),
        dict(CFG["params"], control_variates=True), device="cpu")
    lr.reset()
    rng = np.random.default_rng(seed)
    ens = lr.ens
    P = (1 << D) - 1
    feat = np.full((capacity, P), -1, np.int32)
    thr = np.zeros((capacity, P), np.float32)
    for t in range(n_trees):
        for d in range(D):
            nodes = slice((1 << d) - 1, (1 << (d + 1)) - 1)
            if rng.random() < 0.9:              # a level may not split
                feat[t, nodes] = rng.integers(F)
                thr[t, nodes] = rng.normal(scale=0.05)
    leaves = np.zeros((capacity, 1 << D, O), np.float32)
    leaves[:n_trees] = rng.normal(scale=0.5, size=(n_trees, 1 << D, O))
    bias = (rng.normal(size=O) if n_trees else np.zeros(O)).astype(
        np.float32)
    lr.ens = ens.replace(
        feat=torch.from_numpy(feat), thr=torch.from_numpy(thr),
        cat_code=torch.full((capacity, P), -1, dtype=torch.int32),
        is_split=torch.from_numpy(feat >= 0),
        is_numeric=torch.ones((capacity, P), dtype=torch.bool),
        leaf_values=torch.from_numpy(leaves),
        counts=torch.zeros((capacity, 2 * (1 << D) - 1)),
        depths=torch.zeros(capacity, dtype=torch.int32),
        bias=torch.from_numpy(bias),
        n_trees=torch.tensor(n_trees, dtype=torch.int32))
    return lr


def _heap(lr, n: int) -> dict:
    arrs = {f: getattr(lr.ens, f)[:n].numpy()
            for f in ("feat", "thr", "is_split", "leaf_values")}
    arrs["bias"] = lr.ens.bias.numpy().astype(np.float64)
    return arrs


def _rows(seed: int, n: int) -> np.ndarray:
    return np.random.default_rng(seed).normal(scale=0.05, size=(n, F)) \
        .astype(np.float32)


def _close(got, want, rel=2e-5):
    want = np.asarray(want, np.float64)
    scale = max(float(np.abs(want).max()), 1e-6)
    np.testing.assert_allclose(np.asarray(got, np.float64), want, rtol=0,
                               atol=rel * scale)


@pytest.mark.parametrize("c_library", [True, False])
@pytest.mark.parametrize("n_trees", [0, 1, 5, 40])
def test_mirror_adam_forward_matches_reference(n_trees, c_library,
                                               monkeypatch):
    """The host mirror (its C predictor, and the numpy walk of a host
    without a C compiler) against the reference's sequential recurrence."""
    if not c_library:
        from gbrl_tpu_torch.utils import host_mirror
        monkeypatch.setattr(host_mirror, "_load_lib", lambda: None)
    lr = _learner(n_trees, 10 + n_trees)
    mirror = HostMirror(lr)
    assert mirror.has_adam and mirror.uses_c_library == c_library
    X = _rows(1, 300)
    want = R.forward(torch.from_numpy(X), R._from_heap(_heap(lr, n_trees),
                                                       torch.float64, "cpu"),
                     CFG).numpy()
    _close(mirror.predict(X), want)


@pytest.mark.parametrize("n_trees", [0, 1, 5, 40])
def test_adam_delta_matches_reference(n_trees):
    """The learner's predict (``predict_sgd`` and ``optimizers.adam_delta``
    over the capacity) against the reference, over every tree and over a
    prefix."""
    lr = _learner(n_trees, 20 + n_trees)
    X = _rows(2, 300)
    ens = R._from_heap(_heap(lr, n_trees), torch.float64, "cpu")
    _close(lr._predict_raw(X).numpy(),
           R.forward(torch.from_numpy(X), ens, CFG).numpy())
    stop = max(n_trees // 2, 1)
    pre = {k: v[:stop] if k != "bias" else v for k, v in ens.items()}
    _close(lr._predict_raw(X, 0, stop).numpy(),
           R.forward(torch.from_numpy(X), pre, CFG).numpy())


def test_a2c_update_cv_gradients_and_tree_match_reference(monkeypatch):
    """One fused update on N = 256 rows of an ensemble of 5 trees: the
    control-variate-corrected gradients the tree is fit on, its splits
    and its leaves."""
    n, T = 256, 5
    lr = _learner(T, 7, capacity=8)
    lr._rl_host_n_trees = T
    rng = np.random.default_rng(8)
    obs = _rows(9, n)
    data = dict(actions=rng.integers(0, A, n).astype(np.int64),
                adv=rng.normal(size=n).astype(np.float32),
                ret=rng.normal(size=n).astype(np.float32),
                valid=(rng.random(n) > 0.1).astype(np.float32))
    seen = {}
    build = jit_a2c.build_tree

    def spy(cfg, Xb, cand, grads, *rest):
        seen["grads"] = grads.detach().clone()
        return build(cfg, Xb, cand, grads, *rest)
    monkeypatch.setattr(jit_a2c, "build_tree", spy)
    ens_ref = R._from_heap(_heap(lr, T), torch.float64, "cpu")
    jit_a2c.run_a2c_update(lr, obs, data["actions"], data["adv"],
                           data["ret"], data["valid"],
                           jit_a2c.A2CHyper(A, CFG["hyper"]["ent_coef"],
                                            CFG["hyper"]["vf_coef"], True))
    X = torch.from_numpy(obs)
    P = R.forward(X, ens_ref, CFG)
    _, g = R.loss_grads(P, data, CFG)
    g = R.cv_adjust(g, R.cv_momentum(X, ens_ref, CFG))
    _close(seen["grads"].numpy(), g.numpy(), 1e-4)
    prog = {f: getattr(lr.ens, f)[T].numpy()
            for f in ("feat", "thr", "is_split", "leaf_values")}
    ts = CFG["tree_struct"]
    tree = RT.fit_tree(X, g, torch.ones(n, dtype=torch.float64),
                       torch.ones(F, dtype=torch.float64), D, ts["n_bins"],
                       "cosine", True, follow=prog)
    for f in ("feat", "thr", "is_split"):
        np.testing.assert_array_equal(tree[f].numpy(), prog[f], err_msg=f)
    _close(prog["leaf_values"], tree["leaf_values"].numpy(), 1e-4)


def _agent():
    h = CFG["hyper"]
    return A2C(envs.make("cartpole", 4), tree_struct=dict(CFG["tree_struct"]),
               params=dict(CFG["params"]), policy_lr=h["policy_lr"],
               value_lr=h["value_lr"], policy_algo="Adam", n_steps=16,
               ent_coef=h["ent_coef"], control_variates=True, device="cpu")


def _split_free_learn(algo, total: int, seed: int):
    """``A2C.learn`` as one inline loop, as it was written before its
    rollout and update became methods (the mirror and the fused update)."""
    from gbrl_tpu_torch.ensemble import ensure_capacity
    from gbrl_tpu_torch.rl.buffers import RolloutBuffer
    rng = np.random.default_rng(seed)
    obs, _ = algo.env.reset(seed=seed)
    dones = np.zeros(algo.n_envs, dtype=np.float32)
    buffer = RolloutBuffer(algo.n_steps, algo.n_envs, algo.obs_dim,
                           algo.gamma, algo.gae_lambda)
    algo.curve = []
    steps = 0
    mirror = algo._get_mirror()
    lr = algo.model.learner
    n0 = int(lr.ens.n_trees)
    lr.ens = ensure_capacity(lr.ens, n0 + -(-total // (algo.n_steps
                                                       * algo.n_envs)))
    lr._rl_host_n_trees = n0
    mirror.sync()
    while steps < total:
        for _ in range(algo.n_steps):
            preds = mirror.predict(np.asarray(obs, dtype=np.float32))
            logits = preds[:, :A] - preds[:, :A].max(axis=1, keepdims=True)
            logp = logits - np.log(np.exp(logits).sum(axis=1, keepdims=True))
            u = rng.random(len(obs))
            a = (u[:, None] >= np.cumsum(np.exp(logp), axis=1)).sum(axis=1)
            np.clip(a, 0, A - 1, out=a)
            lp = np.take_along_axis(logp, a[:, None], axis=1)[:, 0]
            next_obs, rewards, terms, truncs, _ = algo.env.step(a)
            done_now = np.logical_or(terms, truncs).astype(np.float32)
            buffer.add(obs, a, rewards, dones, preds[:, A],
                       lp.astype(np.float32))
            algo._ep_ret += rewards
            for i in range(algo.n_envs):
                if done_now[i]:
                    algo.episode_rewards.append(algo._ep_ret[i])
                    algo._ep_ret[i] = 0.0
            obs, dones = next_obs, done_now
        buffer.compute_returns(mirror.predict(
            np.asarray(obs, dtype=np.float32))[:, A], dones)
        b_obs, b_act, _, adv, ret, _, valid = buffer.flat()
        jit_a2c.run_a2c_update(lr, b_obs, b_act, adv, ret, valid,
                               jit_a2c.A2CHyper(A, algo.ent_coef,
                                                algo.vf_coef, True),
                               mirror=mirror)
        steps += algo.n_steps * algo.n_envs
        algo.curve.append(dict(steps=steps,
                               mean_reward_100=algo.mean_reward(),
                               trees=lr._rl_host_n_trees))
    return algo


def test_learn_spans_counters_and_numbers(monkeypatch):
    """A short ``A2C.learn`` under a profiler records every span and
    counter of its loop and its update (each host wait counted as on a
    card), and gives the curve and the trees of the loop it was split
    from."""
    iters, total = 5, 5 * 16 * 4
    want = _split_free_learn(_agent(), total, 3)
    monkeypatch.setattr(profiling, "count_sync",
                        lambda site, on_card, n=1:
                        profiling.count("sync." + site, n))
    before = profiling.counters()
    profiling.clear()
    algo = _agent()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        algo.learn(total, seed=3)
    recs = profiling.records()
    after = profiling.counters()
    assert algo.curve == want.curve
    for f in ("feat", "thr", "is_split", "leaf_values", "bias", "n_trees"):
        np.testing.assert_array_equal(getattr(algo.model.learner.ens, f),
                                      getattr(want.model.learner.ens, f))
    by = {}
    for r in recs:
        by.setdefault(r.name, []).append(r)
    cap = int(algo.model.learner.ens.capacity)
    for name, n in (("iteration", iters), ("rollout", iters),
                    ("mirror.forward", iters * 17), ("update", iters),
                    ("update.stage", iters), ("update.readback", iters),
                    ("adam", iters), ("cv", iters)):
        assert len(by.get(name, [])) == n, name
    ids = {r.id: r for r in recs}
    for r in by["update"]:
        assert r.attrs == {"algo": "a2c"}
        assert ids[r.parent].name == "iteration"
        assert {k: v for k, v in r.counts.items() if k.startswith("sync.")} \
            == {"sync.prepare": 1, "sync.feature_weights": 1,
                "sync.a2c_pack": 1, "sync.a2c_readback": 1}
    for name in ("adam", "cv"):
        assert all(r.attrs == {"rows": 64, "trees": cap} for r in by[name])
        assert all(ids[r.parent].name == "update" for r in by[name])
    assert all(r.attrs == {"rows": 4} for r in by["mirror.forward"])
    assert after.get("sync.a2c_n_trees", 0) \
        - before.get("sync.a2c_n_trees", 0) == 1
    profiling.clear()


@pytest.mark.parametrize("side", ["clean", "sgd_policy", "no_cv"])
def test_check_passes_a_sound_unit_and_fails_the_faults(side):
    """The cell's check on the CPU: a sound 4-iteration unit through the
    harness is correct; the reference in the program's place with the
    policy predicted by SGD, or fit on uncorrected gradients, is not."""
    seed = 2147483001
    r = harness.Run(CELL, seed, 0.0, False, time.perf_counter(),
                    device="cpu")
    if side == "clean":
        r.cfg["total_timesteps"] = 4 * r.agent.iteration_steps(r.cfg)
        out = r.driver.run(r)
        assert harness.judge(r, out["numbers"], out["failed"])[0], \
            out["numbers"]
        return
    k = r.mix["check_steps"]
    unit = L.unit_seeds(seed, 2)[1]
    stand = r.reference.stand_in(r.cfg, unit, k, fault=side)
    ok, _ = harness.judge(r, r.reference.train_check(stand, r.cfg, unit, k),
                          0)
    assert not ok
