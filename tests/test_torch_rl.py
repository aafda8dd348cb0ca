"""The port's RL slice against the JAX package on the CPU: rollout and
replay buffers, PPO minibatch gradients, one fused PPO update phase (on the
level path and on the whole-tree K6 path), one fused A2C update with Adam
and control variates, the host mirror, PPO and A2C learning CartPole in the
JAX package's golden bands, and ``chip_smoke.py``'s numpy CartPole against
gymnasium's.

The JAX and port learners start from one checkpoint (the shared
``.gbrl_model`` format) and take the same rollouts, made with numpy from
fixed seeds.  Tolerances: gradients rtol = atol = 1e-5; trees equal in
structure and thresholds, leaf values within 1e-5 (the port sums leaves and
histograms in another order); mirror predictions within 1e-6 relative."""
import contextlib

import gymnasium as gym
import jax
import numpy as np
import pytest
import torch

from gbrl_tpu.ensemble import ensemble_to_numpy as j_to_numpy
from gbrl_tpu.learners.actor_critic_learner import \
    SharedActorCriticLearner as JShared
from gbrl_tpu.ops import fit as jfit
from gbrl_tpu.rl import buffers as jbuf
from gbrl_tpu.rl import jit_a2c as ja2c
from gbrl_tpu.rl import jit_update as jup
from gbrl_tpu.utils.host_mirror import HostMirror as JMirror

import chip_smoke
from gbrl_tpu_torch.ensemble import ensemble_to_numpy
from gbrl_tpu_torch.learners.actor_critic_learner import \
    SharedActorCriticLearner
from gbrl_tpu_torch.ops import fit as tfit
from gbrl_tpu_torch.ops import kernels as K
from gbrl_tpu_torch.rl import A2C, PPO
from gbrl_tpu_torch.rl import buffers as tbuf
from gbrl_tpu_torch.rl import jit_a2c as ta2c
from gbrl_tpu_torch.rl import jit_update as tup
from gbrl_tpu_torch.utils.host_mirror import HostMirror

TOL = dict(rtol=1e-5, atol=1e-5)
F, NA = 4, 2
O = NA + 1


@pytest.fixture(autouse=True)
def one_thread():
    """One intra-op thread per test process: the runner's workers share
    the machine's cores, and PyTorch thread pools in several processes at
    once slow the RL loops' many small operations by an order of magnitude
    (the same results, in the same order)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cartpole(n=8):
    return gym.vector.SyncVectorEnv([lambda: gym.make("CartPole-v1")] * n)


# ------------------------------------------------------------------ buffers
def test_buffers_match_jax():
    rng = np.random.default_rng(0)
    T, E = 16, 4
    bufs = [jbuf.RolloutBuffer(T, E, 3, 0.98, 0.9),
            tbuf.RolloutBuffer(T, E, 3, 0.98, 0.9)]
    steps = [(rng.normal(size=(E, 3)).astype(np.float32),
              rng.integers(0, 2, E), rng.normal(size=E),
              (rng.random(E) < 0.2).astype(np.float32), rng.normal(size=E),
              rng.normal(size=E)) for _ in range(T)]
    last = (rng.normal(size=E), (rng.random(E) < 0.5).astype(np.float32))
    for b in bufs:
        for s in steps:
            b.add(*s)
        b.compute_returns(*last)
    for a, b in zip(bufs[0].flat(), bufs[1].flat()):
        np.testing.assert_array_equal(a, b)
    # replay buffer: the same rows and the same samples from one seed
    reps = [jbuf.ReplayBuffer(50, 3, 2), tbuf.ReplayBuffer(50, 3, 2)]
    for _ in range(7):
        batch = (rng.normal(size=(8, 3)), rng.normal(size=(8, 2)),
                 rng.normal(size=8), rng.normal(size=(8, 3)),
                 (rng.random(8) < 0.3).astype(np.float32),
                 np.full(8, 0.99))
        for r in reps:
            r.add(*batch)
    assert len(reps[0]) == len(reps[1]) == 50
    for a, b in zip(*(r.sample(16, np.random.default_rng(4)) for r in reps)):
        np.testing.assert_array_equal(a, b)
    # n-step accumulator through terminations and truncations
    accs = [jbuf.NStepAccumulator(2, 3, 0.9), tbuf.NStepAccumulator(2, 3, 0.9)]
    outs = [[], []]
    for t in range(30):
        env = t % 2
        term, trunc = t % 11 == 10, t % 7 == 6
        for acc, out in zip(accs, outs):
            out += acc.add(env, t, -t, float(t) * 0.5, t + 1, term, trunc)
    assert outs[0] == outs[1] and len(outs[0]) > 10


# ---------------------------------------------------------------- gradients
@pytest.mark.parametrize("normalize,clip", [(True, (0.0, 0.0)),
                                            (False, (0.0, 0.0)),
                                            (True, (0.5, 0.3))])
def test_ppo_minibatch_grads_match_jax(normalize, clip):
    rng = np.random.default_rng(1)
    mb = 64
    preds = rng.normal(size=(mb, O)).astype(np.float32)
    actions = rng.integers(0, NA, mb).astype(np.int32)
    logp = preds[:, :NA] - np.log(np.exp(preds[:, :NA]).sum(1, keepdims=True))
    old_logp = (logp[np.arange(mb), actions]
                + rng.normal(scale=0.3, size=mb)).astype(np.float32)
    adv = rng.normal(size=mb).astype(np.float32)
    ret = rng.normal(size=mb).astype(np.float32)
    w = (rng.random(mb) > 0.15).astype(np.float32)
    w[-5:] = 0.0
    kw = dict(n_actions=NA, clip_range=0.2, ent_coef=0.01, vf_coef=0.5,
              normalize_advantage=normalize, policy_clip=clip[0],
              value_clip=clip[1])
    args = (preds, actions, old_logp, adv, ret, w)
    want = np.asarray(jup.ppo_minibatch_grads(
        jup.PPOHyper(**kw), *(jax.numpy.asarray(a) for a in args)))
    got = tup.ppo_minibatch_grads(
        tup.PPOHyper(**kw), *(torch.from_numpy(a) for a in args)).numpy()
    np.testing.assert_allclose(got, want, **TOL)
    assert np.abs(want).max() > 0.1


# ----------------------------------------------------------- update phases
def _learners(tmp_path, policy="greedy", pol_algo="SGD", cv=False):
    """(JAX learner, port learner) from one checkpoint of a JAX learner
    that took two boosting steps: depth 4, 16 bins, cosine."""
    rng = np.random.default_rng(2)
    struct = dict(max_depth=4, n_bins=16, min_data_in_leaf=0,
                  grow_policy=policy)
    params = dict(split_score_func="cosine", generator_type="Quantile",
                  control_variates=cv)
    pol = dict(algo=pol_algo, init_lr=0.17 if pol_algo == "SGD" else 0.05,
               start_idx=0, stop_idx=NA)
    val = dict(algo="SGD", init_lr=0.01, start_idx=NA, stop_idx=O)
    jl = JShared(F, O, struct, pol, val, params, device="cpu")
    jl.reset()
    for _ in range(2):
        jl.step(rng.normal(size=(128, F)).astype(np.float32),
                rng.normal(size=(128, O)).astype(np.float32))
    path = str(tmp_path / f"start_{policy}_{pol_algo}")
    jl.save(path)
    return (JShared.load(path, device="cpu"),
            SharedActorCriticLearner.load(path, device="cpu"))


def _rollout(rng, n):
    obs = rng.normal(size=(n, F)).astype(np.float32)
    obs[: n // 6, 1] = 0.5                     # repeated values
    return (obs, rng.integers(0, NA, n).astype(np.int64),
            rng.normal(scale=0.2, size=n).astype(np.float32) - 0.7,
            rng.normal(size=n).astype(np.float32),
            rng.normal(size=n).astype(np.float32),
            (rng.random(n) > 0.1).astype(np.float32))


def _assert_new_trees_equal(jl, tl, t0):
    j, t = j_to_numpy(jl.ens), ensemble_to_numpy(tl.ens)
    n = int(j["n_trees"])
    assert int(t["n_trees"]) == n > t0
    assert tl._rl_host_n_trees in (None, n)
    for k in ("feat", "is_split", "is_numeric", "depths"):
        np.testing.assert_array_equal(t[k][:n], j[k][:n], err_msg=k)
    np.testing.assert_allclose(t["thr"][:n], j["thr"][:n], rtol=1e-6)
    np.testing.assert_allclose(t["leaf_values"][:n], j["leaf_values"][:n],
                               **TOL)
    np.testing.assert_allclose(t["counts"][:n], j["counts"][:n])


@contextlib.contextmanager
def _tree_path(path):
    """Both packages on the level path or on the whole-tree K6 path (the
    JAX K6 in interpret mode); the JAX jit caches are dropped on the way in
    and out, since its hooks are read while tracing."""
    k6 = path == "k6"
    jax.clear_caches()
    jfit._FORCE_FUSED_INTERPRET = k6
    jfit._DISABLE_FUSED_TREE = not k6
    tfit._DISABLE_FUSED_TREE = not k6
    try:
        yield
    finally:
        jfit._FORCE_FUSED_INTERPRET = False
        jfit._DISABLE_FUSED_TREE = True
        tfit._DISABLE_FUSED_TREE = True
        jax.clear_caches()


@pytest.mark.parametrize("path", ["level", "k6"])
def test_run_ppo_update_matches_jax(tmp_path, path):
    """One update phase from one carried ensemble and one rollout: 300 rows
    in minibatches of 128 (the last one padded and masked), 2 epochs,
    autoreset rows masked, gradient clipping on: the same 6 trees."""
    jl, tl = _learners(tmp_path)
    obs, act, old_lp, adv, ret, valid = _rollout(np.random.default_rng(3),
                                                 300)
    hp = dict(n_actions=NA, clip_range=0.2, ent_coef=0.01, vf_coef=0.5,
              normalize_advantage=True, policy_clip=2.0, value_clip=0.0)
    K.reset_launch_counts()
    with _tree_path(path):
        ej = jup.run_ppo_update(jl, obs, act, old_lp, adv, ret,
                                jup.PPOHyper(**hp), 2, 128,
                                np.random.default_rng(5), valid=valid)
        et = tup.run_ppo_update(tl, obs, act, old_lp, adv, ret,
                                tup.PPOHyper(**hp), 2, 128,
                                np.random.default_rng(5), valid=valid)
    assert K.launch_counts == dict.fromkeys(K.launch_counts, 0)  # CPU
    np.testing.assert_allclose(et, ej, **TOL)
    assert len(et) == 6 and tl._rl_host_n_trees == 2 + 6
    _assert_new_trees_equal(jl, tl, 2)


def test_run_a2c_update_with_mirror_matches_jax(tmp_path):
    """One fused A2C update with an Adam policy and control variates from
    an ensemble that has trees (oblivious, A2C's default): the same tree,
    the same loss statistics, and both mirrors fed from the update's fetch
    predicting alike."""
    jl, tl = _learners(tmp_path, "oblivious", "Adam", cv=True)
    obs, act, _, adv, ret, valid = _rollout(np.random.default_rng(6), 256)
    mirrors = JMirror(jl), HostMirror(tl)
    kw = dict(n_actions=NA, ent_coef=0.01, vf_coef=0.5,
              normalize_advantage=True)
    sj = ja2c.run_a2c_update(jl, obs, act, adv, ret, valid,
                             ja2c.A2CHyper(**kw), mirror=mirrors[0])
    st = ta2c.run_a2c_update(tl, obs, act, adv, ret, valid,
                             ta2c.A2CHyper(**kw), mirror=mirrors[1])
    assert sj.keys() == st.keys()
    np.testing.assert_allclose([st[k] for k in sj], [sj[k] for k in sj],
                               **TOL)
    _assert_new_trees_equal(jl, tl, 2)
    assert mirrors[1].n_synced == 3 and mirrors[1].has_adam
    X = np.random.default_rng(7).normal(size=(64, F)).astype(np.float32)
    want = mirrors[0].predict(X)
    np.testing.assert_allclose(mirrors[1].predict(X), want, rtol=1e-6,
                               atol=1e-6 * np.abs(want).max())
    # the mirror agrees with the device predict it stands in for
    np.testing.assert_allclose(
        mirrors[1].predict(X),
        tl._predict_raw(X).numpy(), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("c_library", [True, False])
def test_host_mirror_matches_jax_mirror(tmp_path, monkeypatch, c_library):
    """Greedy SGD learner: full predictions, the SGD delta over a tree
    range, and incremental syncs, through the C predictor and through the
    numpy walk (a host without a C compiler)."""
    jl, tl = _learners(tmp_path)
    if not c_library:
        from gbrl_tpu_torch.utils import host_mirror
        monkeypatch.setattr(host_mirror, "_load_lib", lambda: None)
    mirrors = [JMirror(jl), HostMirror(tl)]
    assert mirrors[1].uses_c_library == c_library
    rng = np.random.default_rng(8)
    X = rng.normal(size=(100, F)).astype(np.float32)
    for m in mirrors:
        assert m.n_synced == 2
    for _ in range(3):
        Xs = rng.normal(size=(64, F)).astype(np.float32)
        g = rng.normal(size=(64, O)).astype(np.float32)
        jl.step(Xs, g)
        tl.step(Xs, g)
    assert [m.sync() for m in mirrors] == [3, 3]
    want, got = mirrors[0].predict(X), mirrors[1].predict(X)
    np.testing.assert_allclose(got, want, rtol=1e-6,
                               atol=1e-6 * np.abs(want).max())
    want = mirrors[0].predict_range(X, 1, 4)
    np.testing.assert_allclose(mirrors[1].predict_range(X, 1, 4), want,
                               rtol=1e-6, atol=1e-6 * np.abs(want).max())


# ------------------------------------------------------------- golden bands
def test_ppo_cartpole_golden_band():
    """tests/test_rl.py's PPO config and bands (seed-0 JAX run: final
    mean-100 100.61; 28.9 / 53.0 / 74.6 at the checkpoints)."""
    env = _cartpole()
    algo = PPO(env, n_steps=64, batch_size=256, n_epochs=4,
               policy_lr=0.17, value_lr=0.01, device="cpu")
    algo.learn(total_timesteps=15000, seed=0)
    env.close()
    assert algo.model.get_num_trees() == 240
    assert algo._mirror and algo._mirror.uses_c_library
    r = algo.mean_reward()
    assert 80 < r < 122, f"PPO CartPole mean-100 {r} outside [80, 122]"
    cp = {c["steps"]: c["mean_reward_100"] for c in algo.curve}
    for steps, lo, hi in ((4096, 23.0, 35.0), (7680, 42.0, 64.0),
                          (11264, 60.0, 90.0)):
        assert lo < cp[steps] < hi, (steps, cp[steps])
    n = len(algo.episode_rewards)
    assert np.mean(algo.episode_rewards[-n // 3:]) > 1.5 * np.mean(
        algo.episode_rewards[: n // 3])


def test_a2c_adam_cv_golden_band():
    """tests/test_rl.py's A2C config and bands (seed-0 JAX run: final
    mean-100 66.4; 35.0 / 53.2 at the checkpoints)."""
    env = _cartpole()
    algo = A2C(env, n_steps=32, policy_lr=0.3, value_lr=0.02,
               policy_algo="Adam", control_variates=True, device="cpu")
    algo.learn(total_timesteps=10000, seed=0)
    env.close()
    assert algo.model.get_num_trees() == 40
    r = algo.mean_reward()
    assert 48 < r < 90, f"A2C mean-100 {r} outside [48, 90]"
    cp = {c["steps"]: c["mean_reward_100"] for c in algo.curve}
    for steps, lo, hi in ((4096, 24.0, 47.0), (8192, 38.0, 70.0)):
        assert lo < cp[steps] < hi, (steps, cp[steps])
    assert r > cp[2048] * 1.5


# ---------------------------------------------------------------- CartPole
def test_chip_smoke_cartpole_matches_gymnasium():
    """chip_smoke.VecCartPole against gymnasium's CartPole-v1 vector env:
    the same states, the same actions (half the envs balanced by a simple
    controller, so some reach the 500-step truncation) -> equal
    observations, rewards, terminations, truncations and autoreset rows.
    Reset states are random in each, so after an autoreset row the states
    are set equal again."""
    n, steps = 6, 700
    genv, env = _cartpole(n), chip_smoke.VecCartPole(n)
    gobs, _ = genv.reset(seed=3)
    env.reset(seed=3)

    def copy_states(rows):
        for i in rows:
            env.state[i] = genv.envs[i].unwrapped.state

    copy_states(range(n))
    obs = gobs
    rng = np.random.default_rng(0)
    seen = dict(term=0, trunc=0, reset=0)
    for _ in range(steps):
        ctrl = (obs[:, 2] + 0.3 * obs[:, 3] + 0.01 * obs[:, 0]
                + 0.05 * obs[:, 1] > 0).astype(np.int64)
        act = np.where(np.arange(n) < n // 2, ctrl, rng.integers(0, 2, n))
        was_reset = env.autoreset.copy()
        g = genv.step(act)
        m = env.step(act)
        copy_states(np.flatnonzero(was_reset))
        m = (env.state.astype(np.float32),) + m[1:]
        for a, b in zip(g[:4], m[:4]):
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
        seen["term"] += int(g[2].sum())
        seen["trunc"] += int(g[3].sum())
        seen["reset"] += int(was_reset.sum())
        obs = g[0]
    genv.close()
    assert seen["term"] and seen["trunc"] and seen["reset"], seen
