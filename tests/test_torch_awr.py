"""The port's AWR against the JAX package on the CPU: one fused update phase
from one carried state (level path and whole-tree K6 path, learned and
fixed sigma), one facade iteration, the clip gradient at its bounds,
Pendulum runs in both update modes, the Pendulum golden band, and
``chip_smoke.py``'s numpy Pendulum against gymnasium's.

The JAX and port learners start from one checkpoint (the shared
``.gbrl_model`` format) and take the same replay, made with numpy from
fixed seeds; the minibatch plans come from the same numpy generator.
Tolerances: trees equal in structure and thresholds, leaf values within
rtol = atol = 1e-5 (``test_torch_rl.TOL``: the port sums in another
order); the environment within 1e-6."""
import gymnasium as gym
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gbrl_tpu.ensemble import ensure_capacity as j_ensure_capacity
from gbrl_tpu.rl import jit_awr as jawr
from gbrl_tpu.rl.awr import AWR as JAWR

import chip_smoke
from gbrl_tpu_torch.ensemble import ensure_capacity
from gbrl_tpu_torch.learners.gbt_learner import GBTLearner
from gbrl_tpu_torch.ops import kernels as K
from gbrl_tpu_torch.rl import AWR
from gbrl_tpu_torch.rl import jit_awr as tawr
from gbrl_tpu_torch.rl.jit_sac import clip_as_jax
from test_torch_rl import (_assert_new_trees_equal, _tree_path,  # noqa: F401
                           one_thread)

TREE = dict(max_depth=4, n_bins=16, min_data_in_leaf=0, par_th=2,
            grow_policy="oblivious")


def _pendulum(n=4):
    return gym.vector.SyncVectorEnv([lambda: gym.make("Pendulum-v1")] * n)


def _carry(tmp_path, jl, name):
    """The JAX learner's state as a port learner, through a checkpoint."""
    path = str(tmp_path / name)
    jl.save(path)
    return GBTLearner.load(path, device="cpu")


def _awr_pair(tmp_path, learn_std):
    """(JAX AWR, port AWR) with equal learners: depth 4, 16 bins,
    oblivious, Kc = 4, Ka = 3, minibatches of 256, gradient clip on; each
    learner took two boosting steps on random gradients."""
    kw = dict(tree_struct=dict(TREE), actor_updates=3, critic_updates=4,
              batch_size=256, beta=0.5, learn_std=learn_std,
              max_actor_grad_norm=1.5, actor_lr=0.1, critic_lr=0.1)
    ja = JAWR(chip_smoke.VecPendulum(2), device="cpu", **kw)
    ta = AWR(chip_smoke.VecPendulum(2), device="cpu", **kw)
    rng = np.random.default_rng(11)
    for name in ("actor", "critic"):
        jl = getattr(ja, name).learner
        for _ in range(2):
            X = rng.normal(size=(128, 3)).astype(np.float32)
            jl.step(X, rng.normal(size=(128, jl.output_dim)
                                  ).astype(np.float32))
        getattr(ta, name).learner = _carry(tmp_path, jl,
                                           f"{name}_{learn_std}")
    return ja, ta


def _replay(rng, n=600):
    th = rng.uniform(-np.pi, np.pi, n)
    obs = np.stack([np.cos(th), np.sin(th), rng.normal(size=n) * 2],
                   axis=1).astype(np.float32)
    obs[: n // 6, 2] = 0.5                       # repeated values
    act = rng.uniform(-2, 2, (n, 1)).astype(np.float32)
    ret = (rng.normal(size=n) * 30 - 200).astype(np.float32)
    adv = (rng.normal(size=n) * 5).astype(np.float32)
    return obs, act, ret, adv


@pytest.mark.parametrize("learn_std", [True, False])
@pytest.mark.parametrize("path", ["level", "k6"])
def test_run_awr_update_matches_jax(tmp_path, path, learn_std):
    """One fused update phase from one carried state and one replay of 600
    rows: the same 4 critic and 3 actor trees, and the host tree counters
    advanced by them; no kernel launch on the CPU."""
    ja, ta = _awr_pair(tmp_path, learn_std)
    obs, act, ret, adv = _replay(np.random.default_rng(3))
    K.reset_launch_counts()
    with _tree_path(path):
        jawr.run_awr_update(ja, obs, act, ret, np.random.default_rng(5), adv)
        tawr.run_awr_update(ta, obs, act, ret, np.random.default_rng(5), adv)
    assert K.launch_counts == dict.fromkeys(K.launch_counts, 0)
    assert ta.actor.learner._rl_host_n_trees == 2 + 3
    assert ta.critic.learner._rl_host_n_trees == 2 + 4
    _assert_new_trees_equal(ja.actor.learner, ta.actor.learner, 2)
    _assert_new_trees_equal(ja.critic.learner, ta.critic.learner, 2)


def test_awr_update_loop_traces_match_jax(tmp_path):
    """awr_update_loop's per-step losses (kept on the device) against the
    JAX loop's, from one state, with learned sigma."""
    ja, ta = _awr_pair(tmp_path, True)
    obs, act, ret, adv = _replay(np.random.default_rng(4), 300)
    rng = np.random.default_rng(6)
    cmb = rng.integers(0, 300, (4, 256))
    amb = rng.integers(0, 300, (3, 256))
    hp = dict(act_dim=1, beta=0.5, max_weight=20.0, learn_std=True,
              grad_clip=1.5)
    out = []
    for m, awr, arr, grow in ((jawr, ja, jnp.asarray, j_ensure_capacity),
                              (tawr, ta, torch.as_tensor, ensure_capacity)):
        a, c = awr.actor.learner, awr.critic.learner
        ens = [grow(lr.ens, 16) for lr in (a, c)]
        X, _ = a._prepare(obs, grow_vocab=False)
        res = m.awr_update_loop(
            a.cfg, c.cfg, m.AWRHyper(**hp), (a.specs, c.specs), (4, 3),
            ens[0], ens[1], X, arr(act), arr(ret), arr(adv), arr(cmb),
            arr(amb), a._internal_feature_weights())
        out.append([np.asarray(t) for t in res[2]])
    for want, got in zip(*out):
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("lo,hi", [(-2.5, 0.5), (-20.0, 2.0)])
def test_clip_gradient_on_the_bounds_matches_jax(lo, hi):
    """AWR's and SAC's log-sigma clips: inside, outside and exactly on each
    bound, the same values and gradients as ``jnp.clip`` (1/2 on a bound,
    where ``torch.clamp`` gives 1)."""
    x = np.float32([lo - 1.0, lo, 0.25 * (lo + hi), hi, hi + 1.0])
    wts = np.float32([1.0, 2.0, 3.0, 4.0, 5.0])
    want = np.asarray(jax.grad(lambda v: jnp.sum(
        jnp.clip(v, lo, hi) * wts))(jnp.asarray(x)))
    t = torch.tensor(x, requires_grad=True)
    y = clip_as_jax(t, lo, hi)
    (y * torch.from_numpy(wts)).sum().backward()
    np.testing.assert_array_equal(y.detach().numpy(), np.clip(x, lo, hi))
    np.testing.assert_array_equal(t.grad.numpy(), want)
    assert want[1] == 1.0 and want[3] == 2.0     # the half on each bound


def test_awr_facade_iteration_matches_jax():
    """One AWR iteration through the model facades (``jit_update=False``):
    the same rollout on gymnasium's Pendulum, the same critic jump and
    replay, then 4 critic and 3 actor trees equal to the JAX facade's."""
    kw = dict(tree_struct=dict(TREE), n_steps=256, actor_updates=3,
              critic_updates=4, batch_size=128, beta=0.5, learn_std=True,
              jit_update=False, device="cpu")
    algos = []
    for cls in (JAWR, AWR):
        env = _pendulum(2)
        algo = cls(env, **kw)
        algo.learn(256, seed=4)
        env.close()
        algos.append(algo)
    ja, ta = algos
    assert ja.episode_rewards == ta.episode_rewards == []
    for name in ("actor", "critic"):
        jl, tl = getattr(ja, name).learner, getattr(ta, name).learner
        np.testing.assert_allclose(tl.get_bias(), np.asarray(jl.get_bias()),
                                   rtol=1e-6)
        _assert_new_trees_equal(jl, tl, 0)
    assert ta.actor.get_num_trees() == 3 and ta.critic.get_num_trees() == 4


@pytest.mark.parametrize("jit_update", [True, False])
def test_awr_pendulum_runs(jit_update):
    """tests/test_rl.py's test_awr_pendulum_runs on the port."""
    env = _pendulum()
    algo = AWR(env, n_steps=512, actor_updates=4, critic_updates=4,
               batch_size=256, beta=0.5, device="cpu", jit_update=jit_update,
               tree_struct=dict(max_depth=3, n_bins=32, min_data_in_leaf=0,
                                par_th=2, grow_policy="oblivious"))
    algo.learn(total_timesteps=4096, seed=0)
    env.close()
    assert algo.actor.get_num_trees() == algo.critic.get_num_trees() == 32
    assert np.isfinite(algo.mean_reward())
    assert algo._mirrors and algo._mirrors[0].uses_c_library


def test_awr_pendulum_golden_band():
    """tests/test_rl.py's AWR golden band [-1220, -1000] at 16,384 steps,
    seed 0, and the same rise from the trough."""
    env = _pendulum()
    algo = AWR(env, n_steps=512, actor_updates=8, critic_updates=16,
               batch_size=512, beta=0.5, critic_lr=0.1, actor_lr=0.1,
               log_std_final=-1.2, device="cpu",
               tree_struct=dict(max_depth=3, n_bins=32, min_data_in_leaf=0,
                                par_th=2, grow_policy="oblivious"))
    algo.learn(total_timesteps=16384, seed=0)
    env.close()
    r = algo.mean_reward()
    assert -1220 < r < -1000, f"AWR mean-100 {r} outside [-1220, -1000]"
    curve = [c["mean_reward_100"] for c in algo.curve
             if np.isfinite(c["mean_reward_100"])]
    assert r >= min(curve) + 80, f"no improvement: {min(curve)} -> {r}"


def test_chip_smoke_pendulum_matches_gymnasium():
    """chip_smoke.VecPendulum against gymnasium's Pendulum-v1 vector env:
    the same states, the same actions (some past the torque bound) ->
    observations and rewards within 1e-6, equal flags and autoreset rows.
    Reset states are random in each, so after an autoreset row the states
    are set equal again."""
    n, steps = 6, 450
    genv, env = _pendulum(n), chip_smoke.VecPendulum(n)
    genv.reset(seed=3)
    env.reset(seed=3)

    def copy_states(rows):
        for i in rows:
            env.state[i] = genv.envs[i].unwrapped.state

    copy_states(range(n))
    rng = np.random.default_rng(0)
    seen = dict(trunc=0, reset=0)
    for _ in range(steps):
        act = rng.uniform(-2.5, 2.5, (n, 1)).astype(np.float32)
        was_reset = env.autoreset.copy()
        g = genv.step(act)
        m = env.step(act)
        copy_states(np.flatnonzero(was_reset))
        m = (env._obs(),) + m[1:]
        for a, b in zip(g[:2], m[:2]):
            np.testing.assert_allclose(np.asarray(b), np.asarray(a),
                                       rtol=0, atol=1e-6)
        for a, b in zip(g[2:4], m[2:4]):
            np.testing.assert_array_equal(np.asarray(b), np.asarray(a))
        seen["trunc"] += int(g[3].sum())
        seen["reset"] += int(was_reset.sum())
    genv.close()
    assert seen["trunc"] == seen["reset"] == 2 * n, seen
    assert env.single_observation_space.shape == (3,)
    np.testing.assert_array_equal(env.single_action_space.low, [-2.0])
    np.testing.assert_array_equal(env.single_action_space.high, [2.0])
