"""Checkpoints cross between gbrl_tpu and gbrl_tpu_torch, and the port's
learners predict what the JAX learners predict (CPU, rtol = atol = 1e-5).

The JAX learners fit a few boosting steps; the port loads their
``.gbrl_model`` files with ``device="cpu"``."""
import copy

import numpy as np
import pytest
import torch

from gbrl_tpu.ensemble import vars_dict as j_vars_dict
from gbrl_tpu.learners.actor_critic_learner import (
    SeparateActorCriticLearner as JSeparate,
    SharedActorCriticLearner as JShared)
from gbrl_tpu.learners.gbt_learner import GBTLearner as JGBTLearner
from gbrl_tpu.models.actor_critic import ActorCritic as JActorCritic

from gbrl_tpu_torch.ensemble import (ensemble_from_numpy, ensemble_to_numpy,
                                     vars_dict)
from gbrl_tpu_torch.learners import gbt_learner as port_gbt
from gbrl_tpu_torch.learners.actor_critic_learner import (
    SeparateActorCriticLearner, SharedActorCriticLearner)
from gbrl_tpu_torch.models.actor_critic import ActorCritic

TOL = dict(rtol=1e-5, atol=1e-5)
F, O, N = 6, 3, 160


def _opts(policy_algo):
    pol = dict(algo=policy_algo, init_lr=0.05 if policy_algo == "Adam"
               else 0.3, start_idx=0, stop_idx=O - 1)
    val = dict(algo="SGD", scheduler="Linear", init_lr=0.2, stop_lr=0.01,
               T=8, start_idx=O - 1, stop_idx=O)
    return pol, val


def _struct(policy):
    return dict(max_depth=3, n_bins=16, min_data_in_leaf=0,
                grow_policy=policy)


def _data(seed=0):
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(N, F)).astype(np.float32)
    return X, rng


def _fit_shared(policy, algo, steps):
    X, rng = _data()
    pol, val = _opts(algo)
    lr = JShared(F, O, _struct(policy), pol, val,
                 params=dict(split_score_func="cosine"), device="cpu")
    lr.reset()
    lr.set_bias(np.array([0.1, -0.2, 0.5], np.float32))
    for _ in range(steps):
        lr.step(X, rng.normal(size=(N, O)).astype(np.float32))
    return lr, X


def _assert_same(a, b):
    a = a.detach().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
    b = b.detach().numpy() if isinstance(b, torch.Tensor) else np.asarray(b)
    np.testing.assert_allclose(a, b, **TOL)


@pytest.mark.parametrize("policy,algo", [("greedy", "SGD"),
                                         ("oblivious", "SGD"),
                                         ("greedy", "Adam")])
def test_shared_checkpoint_from_jax(tmp_path, policy, algo):
    jl, X = _fit_shared(policy, algo, 5)
    path = str(tmp_path / "shared")
    jl.save(path)
    tl = SharedActorCriticLearner.load(path, device="cpu")
    assert tl.get_num_trees() == jl.get_num_trees() == 5
    jp, jv = jl.predict(X)
    tp, tv = tl.predict(X)
    assert tp.shape == (N, O - 1) and tv.shape == (N,)
    assert tp.requires_grad and tp.device.type == "cpu"
    _assert_same(tp, jp)
    _assert_same(tv, jv)
    _assert_same(tl.predict_policy(X, start_idx=1, stop_idx=4),
                 jl.predict_policy(X, start_idx=1, stop_idx=4))
    _assert_same(tl.predict_critic(X), jl.predict_critic(X))
    _assert_same(tl.predict_async(X), np.asarray(jl.predict_async(X)))
    # one sample as a 1D row; a torch input
    _assert_same(tl.predict(X[0])[0], jl.predict(X[0])[0])
    _assert_same(tl.predict(torch.from_numpy(X))[1], jv)
    assert tl.get_optimizers() == jl.get_optimizers()
    np.testing.assert_array_equal(tl.get_bias(), jl.get_bias())


def test_actor_critic_load_learner_shared_and_separate(tmp_path):
    jl, X = _fit_shared("greedy", "SGD", 4)
    jl.save(str(tmp_path / "sh"))
    jm = JActorCritic.load_learner(str(tmp_path / "sh"), device="cpu")
    tm = ActorCritic.load_learner(str(tmp_path / "sh"), device="cpu")
    assert tm.shared_tree_struct
    for a, b in zip(tm(X), jm(X)):
        _assert_same(a, b)
    _assert_same(tm.predict_policy(X), jm.predict_policy(X))
    _assert_same(tm.predict_values(X), jm.predict_values(X))

    pol, val = _opts("SGD")
    js = JSeparate(F, O, _struct("oblivious"), pol, val, device="cpu")
    js.reset()
    rng = np.random.default_rng(1)
    for _ in range(3):
        js.step(X, [rng.normal(size=(N, O - 1)).astype(np.float32),
                    rng.normal(size=(N, 1)).astype(np.float32)])
    js.save(str(tmp_path / "sep"))
    tsep = SeparateActorCriticLearner.load(str(tmp_path / "sep"),
                                           device="cpu")
    _assert_same(tsep.predict_policy(X), js.predict_policy(X))
    _assert_same(tsep.predict_critic(X), js.predict_critic(X))
    tm2 = ActorCritic.load_learner(str(tmp_path / "sep"), device="cpu")
    assert not tm2.shared_tree_struct
    for a, b in zip(tm2(X), js.predict(X)):
        _assert_same(a, b)


def test_port_checkpoint_loads_in_jax(tmp_path):
    jl, X = _fit_shared("oblivious", "SGD", 4)
    jl.save(str(tmp_path / "a"))
    tl = SharedActorCriticLearner.load(str(tmp_path / "a"), device="cpu")
    tl.save(str(tmp_path / "b"))
    back = JShared.load(str(tmp_path / "b"), device="cpu")
    for a, b in zip(back.predict(X), jl.predict(X)):
        _assert_same(a, b)
    # a model built by the port (no trees) crosses too
    pol, val = _opts("SGD")
    fresh = ActorCritic(_struct("greedy"), F, O, dict(pol), dict(val),
                        bias=0.25, device="cpu")
    fresh.save_learner(str(tmp_path / "c"))
    jfresh = JActorCritic.load_learner(str(tmp_path / "c"), device="cpu")
    for a, b in zip(fresh(X), jfresh(X)):
        _assert_same(a, b)
        _assert_same(a, np.full(a.shape, 0.25, np.float32))


def test_predict_cache_incremental(tmp_path, monkeypatch):
    """Repeated input served from the cache; a model with more trees tops
    the cached prediction up one tree at a time (<= 8 new) or by one delta
    sum (> 8 new), and equals the JAX learner's full predict each time."""
    jl, X = _fit_shared("greedy", "SGD", 0)
    rng = np.random.default_rng(2)
    stages = []
    for k in (3, 2, 10):
        for _ in range(k):
            jl.step(X, rng.normal(size=(N, O)).astype(np.float32))
        path = str(tmp_path / f"s{jl.get_num_trees()}")
        jl.save(path)
        stages.append((path, copy.copy(jl).predict(X, tensor=False)))
    full_calls = []
    real_full = port_gbt._predict_full
    monkeypatch.setattr(port_gbt, "_predict_full",
                        lambda *a, **k: full_calls.append(1) or
                        real_full(*a, **k))
    tl = SharedActorCriticLearner.load(stages[0][0], device="cpu")
    for i, (path, (jp, jv)) in enumerate(stages):
        if i:
            tl.ens = SharedActorCriticLearner.load(path, device="cpu").ens
        tp, tv = tl.predict(X)
        _assert_same(tp, jp)
        _assert_same(tv, jv)
        tp2, _ = tl.predict(X.copy())            # same bytes: served cached
        assert torch.equal(tp, tp2)
    assert len(full_calls) == 1
    assert tl._pred_cache[1] == 15


def test_ensemble_numpy_round_trip():
    jl, _ = _fit_shared("greedy", "SGD", 2)
    from gbrl_tpu.ensemble import ensemble_to_numpy as j_to_numpy
    arrs = j_to_numpy(jl.ens)
    ens = ensemble_from_numpy(arrs, device="cpu")
    assert ens.n_trees.shape == () and ens.n_trees.dtype == torch.int32
    back = ensemble_to_numpy(ens)
    assert back.keys() == arrs.keys()
    for k in arrs:
        assert back[k].dtype == arrs[k].dtype, k
        np.testing.assert_array_equal(back[k], arrs[k])


def test_vars_dict_matches_jax():
    """vars_dict gives gbrl_tpu's keys, in its order, and the ensemble's
    own tensors, equal to the JAX package's arrays."""
    from gbrl_tpu.ensemble import ensemble_to_numpy as j_to_numpy
    jl, _ = _fit_shared("oblivious", "SGD", 3)
    ens = ensemble_from_numpy(j_to_numpy(jl.ens), device="cpu")
    got, want = vars_dict(ens), j_vars_dict(jl.ens)
    assert list(got) == list(want)
    for k, v in got.items():
        assert v is getattr(ens, k) and v.device.type == "cpu"
        np.testing.assert_array_equal(v.numpy(), np.asarray(want[k]))


def _fit_separate(policy, steps=3):
    X, _ = _data()
    pol, val = _opts("SGD")
    js = JSeparate(F, O, _struct(policy), pol, val, device="cpu")
    js.reset()
    rng = np.random.default_rng(1)
    for _ in range(steps):
        js.step(X, [rng.normal(size=(N, O - 1)).astype(np.float32),
                    rng.normal(size=(N, 1)).astype(np.float32)])
    return js, X


@pytest.mark.parametrize("policy", ["greedy", "oblivious"])
def test_separate_predict_matches_jax(tmp_path, policy):
    """SeparateActorCriticLearner.predict: both models, one of them, a
    tree range and numpy output, against gbrl_tpu's."""
    js, X = _fit_separate(policy)
    js.save(str(tmp_path / "sep"))
    ts = SeparateActorCriticLearner.load(str(tmp_path / "sep"), device="cpu")
    got, want = ts.predict(X), js.predict(X)
    assert len(got) == 2 and got[0].shape == (N, O - 1)
    assert got[1].shape == (N,) and got[0].requires_grad
    for a, b in zip(got, want):
        _assert_same(a, b)
    for model_idx in (0, 1):
        _assert_same(ts.predict(X, model_idx=model_idx),
                     js.predict(X, model_idx=model_idx))
    a = ts.predict(X, False, 1, 3, tensor=False, model_idx=0)
    assert isinstance(a, np.ndarray)
    _assert_same(a, js.predict(X, False, 1, 3, tensor=False, model_idx=0))


@pytest.mark.parametrize("shared", [True, False])
def test_actor_critic_save_learner_round_trip(tmp_path, shared):
    """ActorCritic.save_learner of a model the port loaded: loaded again by
    both packages, it predicts what the JAX package's model predicts."""
    jl, X = _fit_shared("greedy", "SGD", 4) if shared else \
        _fit_separate("oblivious")
    jl.save(str(tmp_path / "a"))
    jm = JActorCritic.load_learner(str(tmp_path / "a"), device="cpu")
    tm = ActorCritic.load_learner(str(tmp_path / "a"), device="cpu")
    tm.save_learner(str(tmp_path / "b"))
    back = (ActorCritic.load_learner(str(tmp_path / "b"), device="cpu"),
            JActorCritic.load_learner(str(tmp_path / "b"), device="cpu"))
    for m in back:
        assert m.shared_tree_struct == shared
        for a, b in zip(m(X), jm(X)):
            _assert_same(a, b)
        assert m.get_num_trees() == jm.get_num_trees()


@pytest.mark.parametrize("shared", [True, False])
def test_actor_critic_get_num_trees_matches_jax(tmp_path, shared):
    """An int on a shared model, (actor, critic) on a separate one: 0 on a
    fresh model, then the loaded checkpoint's counts, as gbrl_tpu says."""
    pol, val = _opts("SGD")
    fresh = [cls(_struct("greedy"), F, O, dict(pol), dict(val),
                 shared_tree_struct=shared, device="cpu")
             for cls in (ActorCritic, JActorCritic)]
    assert fresh[0].get_num_trees() == fresh[1].get_num_trees() == \
        (0 if shared else (0, 0))
    jl, _ = _fit_shared("greedy", "SGD", 4) if shared else \
        _fit_separate("greedy", 2)
    jl.save(str(tmp_path / "m"))
    got, want = (cls.load_learner(str(tmp_path / "m"), device="cpu")
                 .get_num_trees() for cls in (ActorCritic, JActorCritic))
    assert got == want == (4 if shared else (2, 2))


def test_gbt_learner_get_device_matches_jax():
    """GBTLearner.get_device reports the device it was given, as
    gbrl_tpu's does, and follows set_device."""
    args = (F, 2, _struct("greedy"),
            dict(algo="SGD", init_lr=0.1, start_idx=0, stop_idx=2))
    tl, jl = port_gbt.GBTLearner(*args, device="cpu"), \
        JGBTLearner(*args, device="cpu")
    assert tl.get_device() == jl.get_device() == "cpu"
    tl.reset()
    tl.set_device("cpu")
    jl.set_device("cpu")
    assert tl.get_device() == jl.get_device() == "cpu"
    assert tl.ens.feat.device.type == "cpu"


# ------------------------------------------------- the reference's methods
REF_CLASSES = [("learners.base", "BaseLearner"),
               ("learners.gbt_learner", "GBTLearner"),
               ("learners.multi_gbt_learner", "MultiGBTLearner"),
               ("learners.actor_critic_learner", "SharedActorCriticLearner"),
               ("learners.actor_critic_learner", "SeparateActorCriticLearner"),
               ("models.base", "BaseGBT"), ("models.gbt", "GBTModel"),
               ("models.actor_critic", "ActorCritic"),
               ("models.actor", "ParametricActor"),
               ("models.actor", "GaussianActor"),
               ("models.critic", "ContinuousCritic"),
               ("models.critic", "DiscreteCritic"),
               ("rl.ppo", "PPO"), ("rl.a2c", "A2C"), ("rl.awr", "AWR"),
               ("rl.sac", "SAC")]


@pytest.mark.parametrize("module,name", REF_CLASSES)
def test_public_methods_exist_on_port(module, name):
    """Every public method of the JAX package's class has a method of that
    name on the port's counterpart."""
    import importlib
    ref = getattr(importlib.import_module(f"gbrl_tpu.{module}"), name)
    port = getattr(importlib.import_module(f"gbrl_tpu_torch.{module}"), name)
    want = [m for m in dir(ref)
            if not m.startswith("_") and callable(getattr(ref, m))]
    missing = [m for m in want if not callable(getattr(port, m, None))]
    assert not missing, f"{name} lacks {missing}"


def _multi_pair():
    from gbrl_tpu.learners.multi_gbt_learner import MultiGBTLearner as JMulti
    from gbrl_tpu_torch.learners.multi_gbt_learner import MultiGBTLearner
    X, rng = _data(5)
    opt = dict(algo="SGD", init_lr=0.2, start_idx=0, stop_idx=2)
    args = (F, 2, _struct("greedy"), opt, dict(split_score_func="l2"), 2)
    jm, tm = JMulti(*args, device="cpu"), MultiGBTLearner(*args, device="cpu")
    for m in (jm, tm):
        m.reset()
    for _ in range(3):
        g = [rng.normal(size=(N, 2)).astype(np.float32) for _ in range(2)]
        jm.step(X, g)
        tm.step(X, g)
    return jm, tm, X, rng


def test_multi_distil_and_metadata_match_jax(capsys):
    """MultiGBTLearner.distil (broadcast and one model) gives the JAX
    package's losses, trees and predictions; print_ensemble_metadata prints
    what the JAX package prints for the same ensembles."""
    jm, tm, X, rng = _multi_pair()
    jm.print_ensemble_metadata()
    want = capsys.readouterr().out
    tm.print_ensemble_metadata()
    assert capsys.readouterr().out == want and "trees=3" in want
    targets = [rng.normal(size=(N, 2)).astype(np.float32) for _ in range(2)]
    params = dict(max_depth=2, distil_budget=4, lr=0.5)
    for model_idx in (None, 1):
        jl = jm.distil(X, targets, params, model_idx=model_idx)
        tl = tm.distil(X, targets, params, model_idx=model_idx)
        jl, tl = (x if model_idx is None else (x,) for x in (jl, tl))
        for (jloss, _), (tloss, _) in zip(jl, tl):
            np.testing.assert_allclose(tloss, jloss, rtol=1e-5)
    for j, t in zip(jm.learners, tm.learners):
        assert t.cfg.max_depth == 2 and t.get_num_trees() == 4
        assert np.array_equal(ensemble_to_numpy(t.ens)["feat"],
                              np.asarray(j.ens.feat))
    for a, b in zip(tm.predict(X, tensor=False), jm.predict(X, tensor=False)):
        _assert_same(a, b)
    jm.print_ensemble_metadata()
    want = capsys.readouterr().out
    tm.print_ensemble_metadata()
    assert capsys.readouterr().out == want


def test_set_device_moves_the_ensembles():
    """set_device on a learner, a multi-learner and a model facade: the
    ensembles' tensors move, predictions stay, get_device reports it; CUDA
    without a card raises, as every entry point does."""
    jm, tm, X, _ = _multi_pair()
    before = tm.predict(X, tensor=False)
    pol, val = _opts("SGD")
    model = ActorCritic(_struct("greedy"), F, O, dict(pol), dict(val),
                        device="cpu")
    learners = [tm, model]
    if torch.cuda.is_available():
        for obj in learners:
            obj.set_device("cuda")
        assert tm.get_device() == ("cuda", "cuda")
        assert all(lr.ens.feat.device.type == "cuda" for lr in tm.learners)
        assert model.get_device() == "cuda"
    else:
        for obj in learners:
            with pytest.raises(RuntimeError, match="no CUDA device"):
                obj.set_device("cuda")
    for obj in learners:
        obj.set_device("cpu")
    assert tm.get_device() == ("cpu", "cpu") and jm.get_device() == \
        ("cpu", "cpu")
    assert all(lr.ens.feat.device.type == "cpu" for lr in tm.learners)
    for a, b in zip(tm.predict(X, tensor=False), before):
        _assert_same(a, b)
    model.set_device("cpu")
    assert model.get_device() == "cpu"
    assert model.learner.ens.feat.device.type == "cpu"
