"""The port's SAC against the JAX package on the CPU: the parametric
Q-forms and the squashed log-probs, one fused train step from one carried
state for each Q-form (ensemble-prefix targets, JAX's noise rebuilt), one
facade train step, the contextual bandits and a Pendulum run.

The JAX and port learners start from one checkpoint; the two critics took
different boosting steps, so the twin minimum is not a tie.  Tolerances:
trees equal in structure and thresholds, leaf values and statistics within
rtol = atol = 1e-5 (``test_torch_rl.TOL``)."""
import gymnasium as gym
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch as th

from gbrl_tpu.rl import jit_sac as jsac
from gbrl_tpu.rl.sac import SAC as JSAC

import chip_smoke
from gbrl_tpu_torch.learners.gbt_learner import GBTLearner
from gbrl_tpu_torch.ops import kernels as K
from gbrl_tpu_torch.rl import SAC
from gbrl_tpu_torch.rl import jit_sac as tsac
from gbrl_tpu_torch.rl.sac import (q_from_params, q_param_dim,
                                   squashed_gaussian_sample)
from test_torch_rl import (TOL, _assert_new_trees_equal,  # noqa: F401
                           one_thread)

N, A = 200, 1
TREE = dict(max_depth=4, n_bins=16, min_data_in_leaf=0, par_th=2,
            grow_policy="oblivious")


def test_q_forms_analytic():
    """tests/test_sac.py's Q-form check on the port, and the fused step's
    q_torch equal to q_from_params and to the JAX q_jax."""
    rng = np.random.default_rng(0)
    n, a_dim = 17, 3
    w = th.as_tensor(rng.normal(size=(n, a_dim)).astype(np.float32))
    a = th.as_tensor(rng.normal(size=(n, a_dim)).astype(np.float32))
    b2 = th.as_tensor(rng.normal(size=(n, 2)).astype(np.float32))
    b1 = b2[:, :1]
    s = (w * a).sum(-1)
    assert th.allclose(q_from_params(w, b1, a, "linear"), s + b1[:, 0])
    assert th.allclose(q_from_params(w, b2, a, "quadratic"),
                       -((s - b2[:, 0]) ** 2) + b2[:, 1])
    assert th.allclose(q_from_params(w, b1, a, "tanh"),
                       b1[:, 0] * th.tanh(s))
    for qtype, b in (("linear", b1), ("quadratic", b2), ("tanh", b1)):
        got = tsac.q_torch(w, b, a, qtype)
        assert th.equal(got, q_from_params(w, b, a, qtype))
        want = np.asarray(jsac.q_jax(*(jnp.asarray(x.numpy())
                                       for x in (w, b, a)), qtype))
        np.testing.assert_allclose(got.numpy(), want, **TOL)
    assert q_param_dim("linear", a_dim) == a_dim + 1
    assert q_param_dim("quadratic", a_dim) == a_dim + 2
    assert q_param_dim("tanh", a_dim) == a_dim + 1


def test_squashed_logp_matches_torch_transformed_and_jax():
    """tests/test_sac.py's log-prob check on the port's facade sampler;
    the fused sampler (explicit Gaussian formula) against it and against
    the JAX fused sampler, with log-sigma past both clip bounds."""
    from torch.distributions import (Independent, Normal,
                                     TransformedDistribution)
    from torch.distributions.transforms import TanhTransform

    g = th.Generator().manual_seed(0)
    mu = th.randn((64, 2), generator=g)
    log_std = th.randn((64, 2), generator=g) * 0.3 - 0.5
    eps = th.randn((64, 2), generator=g)
    a, logp = squashed_gaussian_sample(mu, log_std, eps)
    ref = TransformedDistribution(
        Independent(Normal(mu, th.exp(log_std)), 1),
        [TanhTransform(cache_size=1)])
    u = mu + th.exp(log_std) * eps
    ref_logp = ref.log_prob(th.tanh(u))
    assert th.allclose(logp, ref_logp, atol=2e-3), \
        float((logp - ref_logp).abs().max())
    assert (a.abs() < 1.0).all()
    log_std[:3, 0] = th.tensor([-25.0, 3.0, 2.0])
    eps[:3, 0] = 0.01            # keep tanh off its saturated tail
    fa, flogp = tsac.sample_squashed(mu, log_std, eps)
    ja, jlogp = jsac.sample_squashed(*(jnp.asarray(x.numpy())
                                       for x in (mu, log_std, eps)))
    np.testing.assert_allclose(fa.numpy(), np.asarray(ja), **TOL)
    np.testing.assert_allclose(flogp.numpy(), np.asarray(jlogp), **TOL)
    a2, logp2 = squashed_gaussian_sample(mu, log_std, eps)
    assert th.equal(fa, a2)
    np.testing.assert_allclose(flogp.numpy(), logp2.numpy(), rtol=1e-5,
                               atol=1e-4)


def _sac_pair(tmp_path, qtype, jit_train=True):
    """(JAX SAC, port SAC) on Pendulum's spaces with equal learners: each
    took three boosting steps on random gradients (the two critics on
    different ones); the critics' target prefix is 2 of their 3 trees."""
    kw = dict(tree_struct=dict(TREE), q_func_type=qtype, actor_lr=0.1,
              critic_lr=0.1, batch_size=N, max_grad_norm=1.0,
              target_update_interval=4, jit_train=jit_train)
    js = JSAC(chip_smoke.VecPendulum(2), device="cpu", **kw)
    ts = SAC(chip_smoke.VecPendulum(2), device="cpu", **kw)
    rng = np.random.default_rng(12)
    for i, (jm, tm) in enumerate(zip([js.actor] + js.critics,
                                     [ts.actor] + ts.critics)):
        jl = jm.learner
        for _ in range(3):
            X = rng.normal(size=(64, 3)).astype(np.float32)
            jl.step(X, rng.normal(size=(64, jl.output_dim)).astype(
                np.float32))
        path = str(tmp_path / f"{qtype}_{i}")
        jl.save(path)
        tm.learner = GBTLearner.load(path, device="cpu")
        jl._rl_host_n_trees = tm.learner._rl_host_n_trees = 3
    for c in js.critics + ts.critics:
        c.target_prefix = 2
    return js, ts


def _batch(rng):
    th_ = rng.uniform(-np.pi, np.pi, N)
    obs = np.stack([np.cos(th_), np.sin(th_), rng.normal(size=N) * 2],
                   axis=1).astype(np.float32)
    nth = th_ + rng.normal(size=N) * 0.1
    next_obs = np.stack([np.cos(nth), np.sin(nth), rng.normal(size=N) * 2],
                        axis=1).astype(np.float32)
    return (obs, rng.uniform(-1, 1, (N, A)).astype(np.float32),
            rng.normal(size=N).astype(np.float32) - 3.0, next_obs,
            (rng.random(N) < 0.1).astype(np.float32),
            np.float32(0.9) ** rng.integers(1, 4, N).astype(np.float32))


@pytest.mark.parametrize("qtype", ["linear", "quadratic", "tanh"])
def test_run_sac_train_step_matches_jax(tmp_path, monkeypatch, qtype):
    """One fused train step from one carried state: the JAX step's normal
    draws rebuilt from its key and handed to the port's in place of its
    generator's; targets from a prefix of 2 of 3 trees; the same actor
    tree and two critic trees, the same statistics, temperature and
    target prefixes; no kernel launch on the CPU."""
    js, ts = _sac_pair(tmp_path, qtype)
    batch = _batch(np.random.default_rng(7))
    key = jax.random.PRNGKey(3)
    k_next, k_cur = jax.random.split(key)
    draws = [th.tensor(np.asarray(jax.random.normal(k, (N, A))))
             for k in (k_next, k_cur)]
    real_randn = th.randn

    def randn(shape, generator=None, device=None):
        assert tuple(shape) == (N, A) and generator is not None
        return draws.pop(0).to(device)

    sj = jsac.run_sac_train_step(js, *batch, key)
    K.reset_launch_counts()
    monkeypatch.setattr(th, "randn", randn)
    st = tsac.run_sac_train_step(ts, *batch, th.Generator())
    monkeypatch.setattr(th, "randn", real_randn)
    assert draws == [] and K.launch_counts == dict.fromkeys(
        K.launch_counts, 0)
    assert sj.keys() == st.keys()
    np.testing.assert_allclose([st[k] for k in sj], [sj[k] for k in sj],
                               **TOL)
    np.testing.assert_allclose(ts.log_alpha.detach().numpy(),
                               js.log_alpha.detach().numpy(), rtol=1e-6)
    for jm, tm in zip([js.actor] + js.critics, [ts.actor] + ts.critics):
        assert tm.learner._rl_host_n_trees == 4
        _assert_new_trees_equal(jm.learner, tm.learner, 3)
    # n_trees reached the target interval: the prefix moved to all 4
    assert [c.target_prefix for c in ts.critics] == \
        [c.target_prefix for c in js.critics] == [4, 4]


def test_sac_facade_train_step_matches_jax(tmp_path):
    """One train step through the model facades (``jit_train=False``):
    the target from the critics' prefix, update_critics and update_actor
    with one seeded CPU generator, the temperature step; the same trees,
    losses and temperature as the JAX facade's."""
    js, ts = _sac_pair(tmp_path, "quadratic", jit_train=False)
    batch = _batch(np.random.default_rng(9))
    for s in (js, ts):
        s.buffer.add(*batch)
    infos = [s.train_step(th.Generator().manual_seed(5),
                          np.random.default_rng(2)) for s in (js, ts)]
    np.testing.assert_allclose([infos[1][k] for k in infos[0]],
                               [infos[0][k] for k in infos[0]], **TOL)
    for jm, tm in zip([js.actor] + js.critics, [ts.actor] + ts.critics):
        _assert_new_trees_equal(jm.learner, tm.learner, 3)
    assert [c.target_prefix for c in ts.critics] == \
        [c.target_prefix for c in js.critics] == [4, 4]


class _BanditEnv(gym.Env):
    """tests/test_sac.py's one-step continuous bandit: r = -(a -
    tanh(2 s_0))^2 (interior optimum) or, ``monotone``, r = a tanh(2 s_0)
    (boundary optimum, for the monotone tanh Q-form)."""

    def __init__(self, monotone: bool = False):
        self.observation_space = gym.spaces.Box(-1, 1, (2,), np.float32)
        self.action_space = gym.spaces.Box(-1, 1, (1,), np.float32)
        self.monotone = monotone
        self._rng = np.random.default_rng(0)

    def reset(self, *, seed=None, options=None):
        if seed is not None:
            self._rng = np.random.default_rng(seed)
        self._obs = self._rng.uniform(-1, 1, 2).astype(np.float32)
        return self._obs, {}

    def step(self, action):
        target = np.tanh(2.0 * self._obs[0])
        if self.monotone:
            r = float(action[0] * target)
        else:
            r = -float((action[0] - target) ** 2)
        obs, _ = self.reset()
        return obs, r, True, False, {}


@pytest.mark.parametrize("q_func_type,jit_train", [
    ("linear", True), ("linear", False),
    ("quadratic", True), ("tanh", True)])
def test_sac_bandit_improves(q_func_type, jit_train):
    """tests/test_sac.py's bandit criteria on the port."""
    monotone = q_func_type == "tanh"
    env = gym.vector.SyncVectorEnv(
        [lambda: _BanditEnv(monotone=monotone)] * 8)
    algo = SAC(env, q_func_type=q_func_type, jit_train=jit_train,
               tree_struct=dict(max_depth=3, n_bins=32, min_data_in_leaf=0,
                                par_th=2, grow_policy="oblivious"),
               actor_lr=0.1, critic_lr=0.1, batch_size=256,
               learning_starts=256, train_freq=1, target_update_interval=10,
               log_std_init=-0.7, device="cpu")
    algo.learn(total_timesteps=4000, seed=0)
    env.close()
    assert algo.actor.get_num_trees() > 0
    assert all(c.learner.get_num_trees() > 0 for c in algo.critics)
    n = len(algo.episode_rewards)
    early = np.mean(algo.episode_rewards[: n // 4])
    late = np.mean(algo.episode_rewards[-n // 4:])
    if monotone:
        assert late > early + 0.2, f"no improvement: {early} -> {late}"
    else:
        assert late > early * 0.5, f"no improvement: {early} -> {late}"
    assert np.isfinite(algo.alpha)


def test_sac_pendulum_runs():
    """tests/test_sac.py's Pendulum run on the port: trees grow, rewards
    stay finite, actions respect the env bounds."""
    env = gym.vector.SyncVectorEnv([lambda: gym.make("Pendulum-v1")] * 4)
    algo = SAC(env, tree_struct=dict(max_depth=3, n_bins=32,
                                     min_data_in_leaf=0, par_th=2,
                                     grow_policy="oblivious"),
               learning_starts=200, batch_size=128, train_freq=8,
               device="cpu")
    algo.learn(total_timesteps=1500, seed=0)
    env.close()
    assert algo.actor.get_num_trees() > 0
    assert np.isfinite(algo.mean_reward())
    assert algo._mirror and algo._mirror.uses_c_library
    g = th.Generator().manual_seed(0)
    obs = np.zeros((4, algo.obs_dim), dtype=np.float32)
    a_env = algo._env_action(algo._act(obs, g))
    assert (np.abs(a_env) <= 2.0 + 1e-6).all()
