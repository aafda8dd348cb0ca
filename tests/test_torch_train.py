"""Training through the port against the JAX package on the CPU: boosting
steps and the supervised fit loop ensemble by ensemble, the learners'
step / fit / distil, the actor-critic and model facades, and checkpoints
trained by the port loaded by ``gbrl_tpu``.

Inputs and gradients are made with numpy from fixed seeds and handed to
both packages.  Tolerances: tree structure, thresholds and counts equal;
leaf values, predictions and losses within 1e-5 (the port sums leaves and
histograms in another order)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gbrl_tpu.config import TreeConfig as JConfig
from gbrl_tpu.ensemble import ensemble_to_numpy as j_to_numpy
from gbrl_tpu.ensemble import init_ensemble as j_init
from gbrl_tpu.learners.actor_critic_learner import \
    SharedActorCriticLearner as JShared
from gbrl_tpu.learners.gbt_learner import GBTLearner as JLearner
from gbrl_tpu.models.actor import GaussianActor as JGaussian
from gbrl_tpu.models.actor import ParametricActor as JParametric
from gbrl_tpu.models.actor_critic import ActorCritic as JActorCritic
from gbrl_tpu.models.critic import ContinuousCritic as JContinuous
from gbrl_tpu.models.critic import DiscreteCritic as JDiscrete
from gbrl_tpu.models.gbt import GBTModel as JGBTModel
from gbrl_tpu.ops import boosting as jboost

from gbrl_tpu_torch import (ActorCritic, ContinuousCritic, DiscreteCritic,
                            GaussianActor, GBTLearner, GBTModel,
                            ParametricActor, SharedActorCriticLearner)
from gbrl_tpu_torch.config import TreeConfig
from gbrl_tpu_torch.ensemble import ensemble_to_numpy, init_ensemble
from gbrl_tpu_torch.ops import boosting as tboost

TOL = dict(rtol=1e-5, atol=1e-5)
N, F, O = 300, 5, 3
STRUCT = dict(max_depth=3, n_bins=16, grow_policy="greedy")


def _np(a):
    if isinstance(a, torch.Tensor):
        return a.detach().cpu().numpy()
    return np.asarray(a)


def _assert_ens_equal(t_arrs: dict, j_arrs: dict, thr_ulp: bool = False):
    """``thr_ulp``: thresholds within one f32 ulp of the grid's minimum (a
    jitted JAX program may fuse the uniform grid's ``min + b * step`` into
    one FMA; near zero the difference is many ulps of the result)."""
    for k, want in j_arrs.items():
        got = t_arrs[k]
        if k in ("leaf_values", "bias"):
            np.testing.assert_allclose(got, want, err_msg=k, **TOL)
        elif k == "thr" and thr_ulp:
            np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
        else:
            np.testing.assert_array_equal(got, want, err_msg=k)


def _data(seed=0, n=N):
    rng = np.random.default_rng(seed)
    return rng.normal(size=(n, F)).astype(np.float32), rng


@pytest.mark.parametrize("policy,score,cv", [("greedy", "cosine", False),
                                             ("oblivious", "l2", False),
                                             ("greedy", "l2", True)])
def test_boost_steps_match_jax(policy, score, cv):
    X, rng = _data(1)
    kw = dict(input_dim=F, output_dim=O, n_num_features=F, max_depth=3,
              n_bins=16, grow_policy=policy, split_score_func=score,
              use_control_variates=cv)
    jc, tc = JConfig(**kw), TreeConfig(**kw)
    jens, tens = j_init(jc, capacity=8), init_ensemble(tc, 8, device="cpu")
    fw = rng.uniform(0.5, 1.5, F).astype(np.float32)
    for _ in range(5):
        g = rng.normal(size=(N, O)).astype(np.float32)
        jens = jboost.boost_step(jc, jens, jnp.asarray(X), jnp.asarray(g),
                                 jnp.asarray(fw))
        tens = tboost.boost_step(tc, tens, torch.from_numpy(X),
                                 torch.from_numpy(g), torch.from_numpy(fw))
        _assert_ens_equal(ensemble_to_numpy(tens), j_to_numpy(jens))
    assert int(tens.n_trees) == 5


@pytest.mark.parametrize("cv,generator", [(False, "quantile"),
                                          (True, "uniform")])
def test_fit_loop_matches_jax(cv, generator):
    X, rng = _data(2)
    y = np.stack([X[:, 0] * 2 - X[:, 1], np.sin(X[:, 2]), X[:, 3] > 0],
                 axis=1).astype(np.float32)
    struct = dict(STRUCT, batch_size=128)
    params = dict(control_variates=cv, generator_type=generator)
    opt = dict(algo="SGD", init_lr=0.3, start_idx=0, stop_idx=O)
    jl = JLearner(F, O, struct, opt, params, device="cpu")
    tl = GBTLearner(F, O, struct, opt, params, device="cpu")
    jl.reset()
    tl.reset()
    if cv:
        # the JAX package's fit with control variates from zero trees gives
        # NaN (its momentum multiplies 0 by 1 / sqrt(1 - beta^0)); compare
        # from an ensemble that has trees, and see the port stay finite
        fresh = GBTLearner(F, O, struct, opt, params, device="cpu")
        fresh.reset()
        assert np.isfinite(fresh.fit(X, y, 3))
        for _ in range(2):
            g = rng.normal(size=(N, O)).astype(np.float32)
            jl.step(X, g)
            tl.step(X, g)
    jloss = jl.fit(X, y, 12, seed=3)
    tloss = tl.fit(X, y, 12, seed=3)
    np.testing.assert_allclose(tloss, jloss, rtol=1e-5)
    np.testing.assert_allclose(tl._last_fit_losses, jl._last_fit_losses,
                               rtol=1e-5)
    _assert_ens_equal(ensemble_to_numpy(tl.ens), j_to_numpy(jl.ens),
                      thr_ulp=generator == "uniform")
    np.testing.assert_allclose(_np(tl.predict(X)), _np(jl.predict(X)), **TOL)
    assert tl._bias_version == jl._bias_version


def test_learner_step_fit_distil():
    X, rng = _data(3)
    opt = dict(algo="SGD", init_lr=0.2, start_idx=0, stop_idx=O)
    jl = JLearner(F, O, STRUCT, opt, dict(split_score_func="l2"),
                  device="cpu")
    tl = GBTLearner(F, O, STRUCT, opt, dict(split_score_func="l2"),
                    device="cpu")
    for lr in (jl, tl):
        lr.reset()
        lr.set_bias(np.array([0.5, -1.0, 0.25], np.float32))
        lr.set_feature_weights(np.array([1, 0, 1, 2, 1], np.float32))
    for i in range(3):
        g = rng.normal(size=(N, O)).astype(np.float32)
        jl.step(X, g)
        # a tuple of column blocks, one of them a tensor
        tl.step(X, (g[:, :2], torch.from_numpy(g[:, 2:])) if i else g)
        _assert_ens_equal(ensemble_to_numpy(tl.ens), j_to_numpy(jl.ens))
    assert tl.get_num_trees() == 3 and tl.get_total_iterations() == 3
    np.testing.assert_allclose(_np(tl.predict(X)), _np(jl.predict(X)), **TOL)
    # fit continues the ensemble (bias reset to the targets' mean)
    y = rng.normal(size=(N, O)).astype(np.float32)
    np.testing.assert_allclose(tl.fit(X, y, 4), jl.fit(X, y, 4), rtol=1e-5)
    _assert_ens_equal(ensemble_to_numpy(tl.ens), j_to_numpy(jl.ens))
    # distil swaps in a depth-2 student fitted to the teacher's outputs
    targets = _np(jl.predict(X))
    params = dict(max_depth=2, distil_budget=6, lr=0.5)
    jloss, _ = jl.distil(X, targets, params)
    tloss, _ = tl.distil(X, targets, params)
    np.testing.assert_allclose(tloss, jloss, rtol=1e-5)
    assert tl.cfg.max_depth == 2 and tl.get_num_trees() == 6
    _assert_ens_equal(ensemble_to_numpy(tl.ens), j_to_numpy(jl.ens))
    assert tl._pred_cache is None and tl._bias_version == jl._bias_version
    np.testing.assert_allclose(_np(tl.predict(X)), _np(jl.predict(X)), **TOL)


def _ac_opts():
    pol = dict(algo="SGD", lr=0.1, start_idx=0, stop_idx=O - 1)
    val = dict(algo="SGD", lr="lin_0.05", T=20, start_idx=O - 1, stop_idx=O)
    return pol, val


@pytest.mark.parametrize("shared", [True, False])
def test_actor_critic_step_matches_jax(shared):
    X, rng = _data(4)
    pol, val = _ac_opts()
    struct = dict(STRUCT, grow_policy="oblivious" if shared else "greedy")
    jm = JActorCritic(struct, F, O, dict(pol), dict(val),
                      shared_tree_struct=shared, device="cpu")
    tm = ActorCritic(struct, F, O, dict(pol), dict(val),
                     shared_tree_struct=shared, device="cpu")
    for _ in range(3):
        pg = rng.normal(size=(N, O - 1)).astype(np.float32)
        vg = rng.normal(size=(N,)).astype(np.float32)
        jm.step(X, pg, vg)
        tm.step(X, pg, vg)
    if not shared:
        pg = rng.normal(size=(N, O - 1)).astype(np.float32)
        jm.actor_step(X, pg)
        tm.actor_step(X, pg)
        vg = rng.normal(size=(N,)).astype(np.float32)
        jm.critic_step(X, vg)
        tm.critic_step(X, vg)
    for a, b in zip(tm(X), jm(X)):
        np.testing.assert_allclose(_np(a), _np(b), **TOL)
    assert tm.get_num_trees() == jm.get_num_trees()

    # the autograd path: gradients of a mean loss, scaled by n, step a tree
    theta, value = tm(X)
    (theta.sum(1) ** 2 + value).mean().backward()
    want_pg = _np(theta.grad) * N
    tm.step()
    jm.step(X, want_pg, np.ones(N, np.float32))
    for a, b in zip(tm(X), jm(X)):
        np.testing.assert_allclose(_np(a), _np(b), **TOL)


def test_port_trained_checkpoint_loads_in_jax(tmp_path):
    X, rng = _data(5)
    pol, val = _ac_opts()
    tm = ActorCritic(STRUCT, F, O, dict(pol), dict(val), device="cpu")
    for _ in range(4):
        tm.step(X, rng.normal(size=(N, O - 1)).astype(np.float32),
                rng.normal(size=(N,)).astype(np.float32))
    path = str(tmp_path / "ac")
    tm.save_learner(path)
    jm = JActorCritic.load_learner(path, device="cpu")
    assert jm.get_num_trees() == 4
    for a, b in zip(tm(X), jm(X)):
        np.testing.assert_allclose(_np(a), _np(b), **TOL)
    # and the shared learner's distil runs on the loaded port model
    jl = JShared.load(path, device="cpu")
    tl = SharedActorCriticLearner.load(path, device="cpu")
    p, v = (_np(a) for a in jl.predict(X))
    params = dict(max_depth=2, distil_budget=3)
    np.testing.assert_allclose(tl.distil(X, p, v, params)[0],
                               jl.distil(X, p, v, params)[0], rtol=1e-5)


def test_gbt_model_fit_and_step_match_jax():
    X, rng = _data(6)
    y = (X[:, :2] * [1.0, -2.0]).astype(np.float32)
    opt = dict(algo="SGD", lr=0.5, start_idx=0, stop_idx=2)
    jm = JGBTModel(STRUCT, F, 2, opt, device="cpu")
    tm = GBTModel(STRUCT, F, 2, opt, device="cpu")
    np.testing.assert_allclose(tm.fit(X, y, 5), jm.fit(X, y, 5), rtol=1e-5)
    pred = tm(X)
    ((pred - torch.from_numpy(y)) ** 2).mean().backward()
    jm.step(X, _np(pred.grad) * N)
    tm.step()
    np.testing.assert_allclose(_np(tm(X, requires_grad=False)),
                               _np(jm(X, requires_grad=False)), **TOL)


MODELS = {
    "parametric": (ParametricActor, JParametric,
                   lambda: (dict(algo="SGD", lr=0.2, start_idx=0,
                                 stop_idx=3),), 3),
    "gaussian": (GaussianActor, JGaussian,
                 lambda: (dict(algo="SGD", lr=0.2, start_idx=0, stop_idx=2),
                          dict(algo="SGD", lr=0.1, start_idx=2, stop_idx=4)),
                 4),
    "continuous": (ContinuousCritic, JContinuous,
                   lambda: (dict(algo="SGD", lr=0.2, start_idx=0, stop_idx=2),
                            dict(algo="SGD", lr=0.1, start_idx=2,
                                 stop_idx=3)), 3),
    "discrete": (DiscreteCritic, JDiscrete,
                 lambda: (dict(algo="SGD", lr=0.2, start_idx=0, stop_idx=3),),
                 3),
}


@pytest.mark.parametrize("kind", sorted(MODELS))
def test_model_facades_step_match_jax(kind):
    cls, jcls, opts, out = MODELS[kind]
    X, rng = _data(7)
    kw = dict(target_update_interval=2) if "critic" in cls.__name__.lower() \
        else {}
    tm = cls(STRUCT, F, out, *opts(), device="cpu", **kw)
    jm = jcls(STRUCT, F, out, *opts(), device="cpu", **kw)
    for _ in range(2):
        outs = _as_tuple(tm(X))
        sum(o.float().pow(2).sum() for o in outs if o.requires_grad).backward()
        grads = [_np(o.grad) * N for o in outs if o.requires_grad]
        tm.step()
        jm(X)
        jm.step(X, *grads)
    pairs = [(tm(X, requires_grad=False), jm(X, requires_grad=False))]
    if hasattr(tm, "predict_target"):
        pairs.append((tm.predict_target(X), jm.predict_target(X)))
    for got, want in pairs:
        for a, b in zip(_as_tuple(got), _as_tuple(want)):
            np.testing.assert_allclose(_np(a), _np(b), **TOL)


def _as_tuple(x):
    return x if isinstance(x, tuple) else (x,)
