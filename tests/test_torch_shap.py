"""The port's SHAP against gbrl_tpu's on the CPU.

Ensembles are grown by gbrl_tpu from a seed (depth 2-4, at most 5 features,
5 trees in a capacity of 8) and carried across with ``ensemble_to_numpy`` /
``ensemble_from_numpy`` or a checkpoint.  The host recursion, the
brute-force oracle and the reference-compatible form are bit-equal to
gbrl_tpu's; the device form (here on CPU tensors) is within the JAX tests'
``rtol=1e-4, atol=1e-5`` of gbrl_tpu's XLA form (tests/test_shap.py)."""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from gbrl_tpu.config import TreeConfig as JConfig
from gbrl_tpu.ensemble import ensemble_to_numpy as j_to_numpy
from gbrl_tpu.ensemble import init_ensemble as j_init
from gbrl_tpu.ops import shap as jshap
from gbrl_tpu.ops import shap_refcompat as jref
from gbrl_tpu.ops.boosting import boost_step as j_boost
from gbrl_tpu.ops.shap_device import ensemble_shap_device as j_device
from gbrl_tpu.ops.shap_device import tree_shap_device_one as j_device_one

from chip_smoke import expected_raw
from gbrl_tpu_torch.config import TreeConfig
from gbrl_tpu_torch.ensemble import ensemble_from_numpy, ensemble_to_numpy
from gbrl_tpu_torch.ops import shap as tshap
from gbrl_tpu_torch.ops import shap_device as tdev
from gbrl_tpu_torch.ops import shap_refcompat as tref
from gbrl_tpu_torch.ops.predict import weighted_leaf_sum

TOL = dict(rtol=1e-4, atol=1e-5)
N, O, TREES, CAP = 60, 2, 5, 8
# (numeric, categorical) features: the mixed case has more categorical
# than numeric features, so a categorical node's feature indexes past the
# numeric block (the clamped gathers of ops/shap_device.py)
KINDS = {"numeric": (4, 0), "mixed": (1, 3)}
GRID = [(p, d, k) for p in ("greedy", "oblivious") for d in (2, 3, 4)
        for k in KINDS]


@pytest.fixture(scope="module")
def grown():
    """(policy, depth, kind) -> (JAX config, JAX ensemble, port config,
    port ensemble on the CPU, Xn, Xc), grown once per module."""
    cache = {}

    def get(policy, depth, kind):
        key = (policy, depth, kind)
        if key not in cache:
            fn, fc = KINDS[kind]
            rng = np.random.default_rng(depth + 7 * (kind == "mixed"))
            kw = dict(input_dim=fn + fc, output_dim=O, n_num_features=fn,
                      n_cat_features=fc, max_depth=depth, n_bins=8,
                      grow_policy=policy, split_score_func="cosine")
            jcfg = JConfig(**kw)
            Xn = rng.normal(size=(N, fn)).astype(np.float32)
            Xc = (rng.integers(0, 4, (N, fc)).astype(np.int32) if fc
                  else None)
            ens = j_init(jcfg, capacity=CAP)
            for _ in range(TREES):
                g = jnp.asarray(rng.normal(size=(N, O)).astype(np.float32))
                if fc:
                    ens = j_boost(jcfg, ens, jnp.asarray(Xn), g,
                                  jnp.ones(fn), jnp.asarray(Xc),
                                  jnp.ones(fc), 8)
                else:
                    ens = j_boost(jcfg, ens, jnp.asarray(Xn), g, jnp.ones(fn))
            tens = ensemble_from_numpy(j_to_numpy(ens), device="cpu")
            cache[key] = (jcfg, ens, TreeConfig(**kw), tens, Xn, Xc)
        return cache[key]
    return get


def _t(a):
    return None if a is None else torch.from_numpy(a)


def _rows(a, n):
    return None if a is None else a[:n]


@pytest.mark.parametrize("policy,depth,kind", GRID)
def test_host_forms_bit_equal_jax(grown, policy, depth, kind):
    """The recursion, the brute-force oracle and the reference-compatible
    form give gbrl_tpu's values bit for bit, from the port's tensors."""
    jcfg, jens, cfg, ens, Xn, Xc = grown(policy, depth, kind)
    x, xc = Xn[:6], _rows(Xc, 6)
    assert np.array_equal(tshap.ensemble_shap_values(cfg, ens, x, xc),
                          jshap.ensemble_shap_values(jcfg, jens, x, xc))
    assert np.array_equal(tshap.tree_shap_values(cfg, ens, 1, x, xc),
                          jshap.tree_shap_values(jcfg, jens, 1, x, xc))
    for i in range(2):
        ci = None if Xc is None else Xc[i]
        assert np.array_equal(tshap.brute_force_shap(cfg, ens, 0, Xn[i], ci),
                              jshap.brute_force_shap(jcfg, jens, 0, Xn[i], ci))
    for tree_idx in (None, 2):
        assert np.array_equal(
            tref.ensemble_shap_ref_compat(cfg, ens, x, xc, tree_idx),
            jref.ensemble_shap_ref_compat(jcfg, jens, x, xc, tree_idx))


@pytest.mark.parametrize("policy,depth,kind", GRID)
def test_device_form_matches_jax(grown, policy, depth, kind):
    """The port's device form on CPU tensors against gbrl_tpu's XLA form
    and against the recursion."""
    jcfg, jens, cfg, ens, Xn, Xc = grown(policy, depth, kind)
    x, xc = Xn[:8], _rows(Xc, 8)
    F = cfg.input_dim
    got = tdev.ensemble_shap_device(cfg, ens, _t(x), _t(xc), F).numpy()
    want = np.asarray(j_device(jcfg, jens, jnp.asarray(x),
                               None if xc is None else jnp.asarray(xc), F))
    assert got.shape == (8, F, O)
    np.testing.assert_allclose(got, want, **TOL)
    np.testing.assert_allclose(
        got, tshap.ensemble_shap_values(cfg, ens, x, xc), **TOL)


def test_device_form_one_tree(grown):
    jcfg, jens, cfg, ens, Xn, Xc = grown("greedy", 3, "mixed")
    x, xc = Xn[:8], Xc[:8]
    for t in (0, TREES - 1):
        got = tdev.ensemble_shap_device(cfg, ens, _t(x), _t(xc), 4, t)
        want = j_device(jcfg, jens, jnp.asarray(x), jnp.asarray(xc), 4,
                        jnp.int32(t))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    with pytest.raises(IndexError):
        tdev.ensemble_shap_device(cfg, ens, _t(x), _t(xc), 4, CAP)


@pytest.mark.parametrize("policy,kind", [(p, k) for p in ("greedy",
                                                          "oblivious")
                                         for k in KINDS])
def test_tree_shap_device_one_matches_jax(grown, policy, kind):
    """One tree given by its own arrays, against gbrl_tpu's
    tree_shap_device_one and against the ensemble's tree_idx form."""
    jcfg, jens, cfg, ens, Xn, Xc = grown(policy, 3, kind)
    x, xc = Xn[:8], _rows(Xc, 8)
    F = cfg.input_dim
    fields = ("feat", "thr", "cat_code", "is_split", "is_numeric", "counts",
              "leaf_values")
    for t in (0, TREES - 1):
        got = tdev.tree_shap_device_one(
            cfg, *(getattr(ens, f)[t] for f in fields), _t(x), _t(xc), F)
        want = j_device_one(
            jcfg, *(getattr(jens, f)[t] for f in fields), jnp.asarray(x),
            None if xc is None else jnp.asarray(xc), F)
        assert got.shape == (8, F, O)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
        assert torch.equal(got, tdev.ensemble_shap_device(
            cfg, ens, _t(x), _t(xc), F, t))


@pytest.mark.parametrize("policy", ["greedy", "oblivious"])
def test_device_form_ignores_stale_slots(grown, policy):
    """Finite junk in the slots past n_trees: the port never reads them
    (the same bits as the clean ensemble) and agrees with gbrl_tpu's
    masked scan over the junk ensemble."""
    jcfg, jens, cfg, ens, Xn, _ = grown(policy, 3, "numeric")
    rng = np.random.default_rng(11)
    arrs = {k: v.copy() for k, v in j_to_numpy(jens).items()}
    stale = slice(TREES, CAP)
    arrs["feat"][stale] = rng.integers(0, 4, arrs["feat"][stale].shape)
    arrs["thr"][stale] = rng.normal(size=arrs["thr"][stale].shape)
    arrs["is_split"][stale] = True
    arrs["leaf_values"][stale] = rng.normal(
        size=arrs["leaf_values"][stale].shape)
    arrs["counts"][stale] = rng.uniform(1, 9, arrs["counts"][stale].shape)
    x = _t(Xn[:8])
    junk = tdev.ensemble_shap_device(
        cfg, ensemble_from_numpy(arrs, "cpu"), x, None, 4)
    assert torch.equal(junk, tdev.ensemble_shap_device(cfg, ens, x, None, 4))
    jjunk = jens.replace(**{k: jnp.asarray(arrs[k]) for k in
                            ("feat", "thr", "is_split", "leaf_values",
                             "counts")})
    want = j_device(jcfg, jjunk, jnp.asarray(Xn[:8]), None, 4)
    np.testing.assert_allclose(junk.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("policy", ["greedy", "oblivious"])
def test_local_accuracy(grown, policy):
    """sum_f phi[n, f, o] + E_raw[o] equals the raw leaf sum
    sum_t leaf_t(x) (the predict path with unit coefficients), in the form
    of tests/test_shap.py's local-accuracy check; E_raw is
    chip_smoke.expected_raw, as phase 15 computes it on the card."""
    _, _, cfg, ens, Xn, _ = grown(policy, 4, "numeric")
    x = _t(Xn)
    phi = tdev.ensemble_shap_device(cfg, ens, x, None, 4).numpy()
    coeff = (torch.arange(CAP) < TREES).float()[:, None].expand(CAP, O)
    raw = weighted_leaf_sum(cfg, ens, x, coeff.contiguous()).numpy()
    e_raw = expected_raw(ensemble_to_numpy(ens), 4, TREES)
    np.testing.assert_allclose(phi.sum(axis=1) + e_raw, raw, rtol=1e-4,
                               atol=1e-5)


def test_tf32_stays_off_while_shap_runs(grown, monkeypatch):
    """Every matmul of a SHAP call runs with TF32 off and the float32
    matmul precision at "highest" (the JAX package's HIGHEST)."""
    *_, cfg, ens, Xn, Xc = grown("oblivious", 2, "mixed")
    seen = []
    real = torch.Tensor.addmm_

    def addmm_(acc, a, b):
        seen.append((torch.backends.cuda.matmul.allow_tf32,
                     torch.get_float32_matmul_precision()))
        return real(acc, a, b)
    monkeypatch.setattr(torch.Tensor, "addmm_", addmm_)
    tdev.ensemble_shap_device(cfg, ens, _t(Xn), _t(Xc), 4)
    assert seen and all(s == (False, "highest") for s in seen), seen


# ------------------------------------------------ learners and facades
def _mixed_obs(rng, n):
    """Object rows: one numeric column, then three categorical ones."""
    X = np.empty((n, 4), dtype=object)
    X[:, 0] = rng.normal(size=n).astype(np.float32)
    for j in range(1, 4):
        X[:, j] = rng.choice(["a", "b", "c", "d"], n)
    return X


def _same_shap(a, b, exact=False):
    for x, y in zip(a if isinstance(a, tuple) else (a,),
                    b if isinstance(b, tuple) else (b,)):
        assert isinstance(x, np.ndarray) and x.shape == np.shape(y)
        if exact:
            assert np.array_equal(x, np.asarray(y))
        else:
            np.testing.assert_allclose(x, np.asarray(y), **TOL)


def test_gbt_model_shap_matches_jax(tmp_path):
    """GBTModel on mixed rows (categorical block larger than the numeric
    one): shap, tree_shap and ref_compat (bit-equal) from a checkpoint the
    JAX package wrote."""
    from gbrl_tpu.models.gbt import GBTModel as JGBTModel
    from gbrl_tpu_torch.models.gbt import GBTModel
    rng = np.random.default_rng(3)
    X = _mixed_obs(rng, N)
    jm = JGBTModel(tree_struct=dict(max_depth=2, n_bins=8), input_dim=4,
                   output_dim=O, optimizers=dict(algo="SGD", lr=0.3,
                                                 start_idx=0, stop_idx=O),
                   device="cpu")
    for _ in range(4):
        jm.step(X, grads=rng.normal(size=(N, O)).astype(np.float32))
    jm.save_learner(str(tmp_path / "m"))
    tm = GBTModel.load_learner(str(tmp_path / "m"), device="cpu")
    x = X[:8]
    _same_shap(tm.shap(x), jm.shap(x))
    _same_shap(tm.tree_shap(1, x), jm.tree_shap(1, x))
    _same_shap(tm.shap(x, ref_compat=True), jm.shap(x, ref_compat=True),
               exact=True)
    _same_shap(tm.tree_shap(2, x, ref_compat=True),
               jm.tree_shap(2, x, ref_compat=True), exact=True)


def test_multi_learner_shap_matches_jax(tmp_path):
    """MultiGBTLearner: shap and tree_shap broadcast over the models and
    addressed by model_idx."""
    from gbrl_tpu.learners.multi_gbt_learner import MultiGBTLearner as JMulti
    from gbrl_tpu_torch.learners.multi_gbt_learner import MultiGBTLearner
    rng = np.random.default_rng(4)
    X = rng.normal(size=(N, 4)).astype(np.float32)
    jm = JMulti(4, O, dict(max_depth=2, n_bins=8, grow_policy="oblivious"),
                dict(algo="SGD", init_lr=0.2, start_idx=0, stop_idx=O),
                n_learners=2, device="cpu")
    jm.reset()
    for _ in range(3):
        jm.step(X, [rng.normal(size=(N, O)).astype(np.float32)
                    for _ in range(2)])
    jm.save(str(tmp_path / "multi"))
    tm = MultiGBTLearner.load(str(tmp_path / "multi"), device="cpu")
    x = X[:8]
    _same_shap(tm.shap(x), jm.shap(x))
    _same_shap(tm.shap(x, model_idx=1), jm.shap(x, model_idx=1))
    _same_shap(tm.tree_shap(2, x, model_idx=0),
               jm.tree_shap(2, x, model_idx=0))


def test_actor_critic_shap_matches_jax(tmp_path):
    """ActorCritic (shared ensemble): shap, tree_shap and ref_compat."""
    from gbrl_tpu.models.actor_critic import ActorCritic as JActorCritic
    from gbrl_tpu_torch.models.actor_critic import ActorCritic
    rng = np.random.default_rng(5)
    X = rng.normal(size=(N, 4)).astype(np.float32)
    pol = dict(algo="SGD", lr=0.1, start_idx=0, stop_idx=2)
    val = dict(algo="SGD", lr=0.05, start_idx=2, stop_idx=3)
    jm = JActorCritic(dict(max_depth=2, n_bins=8), 4, 3, pol, val,
                      device="cpu")
    for _ in range(3):
        jm.step(X, rng.normal(size=(N, 2)).astype(np.float32),
                rng.normal(size=(N,)).astype(np.float32))
    jm.save_learner(str(tmp_path / "ac"))
    tm = ActorCritic.load_learner(str(tmp_path / "ac"), device="cpu")
    x = X[:8]
    _same_shap(tm.shap(x), jm.shap(x))
    _same_shap(tm.tree_shap(0, x), jm.tree_shap(0, x))
    _same_shap(tm.shap(x, ref_compat=True), jm.shap(x, ref_compat=True),
               exact=True)
