"""gbrl_tpu_torch.optimizers against gbrl_tpu.optimizers on the CPU:
schedulers, the SGD coefficient matrix and the closed-form chunked Adam
recurrence, with start/stop tree ranges.  Tolerance 1e-5 (f32 pow/exp
implementations differ between XLA and torch in the last bits)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gbrl_tpu import optimizers as jopt
from gbrl_tpu.config import TreeConfig as JTreeConfig
from gbrl_tpu.ensemble import ensemble_to_numpy as j_to_numpy
from gbrl_tpu.ensemble import init_ensemble as j_init_ensemble

from gbrl_tpu_torch import optimizers as topt
from gbrl_tpu_torch.config import TreeConfig
from gbrl_tpu_torch.ensemble import ensemble_from_numpy

TOL = dict(rtol=1e-5, atol=1e-5)
SPECS = [dict(algo="SGD", scheduler="Const", init_lr=0.3, start_idx=0,
              stop_idx=2),
         dict(algo="SGD", scheduler="Linear", init_lr=0.5, stop_lr=0.01,
              T=20, start_idx=2, stop_idx=3)]


@pytest.mark.parametrize("spec", SPECS)
def test_scheduler_lr_matches_jax(spec):
    t = np.arange(40, dtype=np.int32)
    want = jopt.scheduler_lr(jopt.OptimizerSpec(**spec), jnp.asarray(t))
    got = topt.scheduler_lr(topt.OptimizerSpec(**spec), torch.from_numpy(t))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("start,stop", [(0, 32), (3, 11), (5, 6)])
def test_sgd_coeff_matches_jax(start, stop):
    js = tuple(jopt.OptimizerSpec(**s) for s in SPECS)
    ts = tuple(topt.OptimizerSpec(**s) for s in SPECS)
    want = jopt.sgd_coeff(js, 32, 3, jnp.int32(13), start, stop)
    got = topt.sgd_coeff(ts, 32, 3, torch.tensor(13, dtype=torch.int32),
                         start, stop)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_optimizer_spec_from_dict_conventions():
    d = dict(lr="lin_0.2", start_idx=0, stop_idx=1, T=50, junk=1)
    assert topt.OptimizerSpec.from_dict(d) == topt.OptimizerSpec(
        scheduler="Linear", init_lr=0.2, T=50, start_idx=0, stop_idx=1)
    assert topt.OptimizerSpec.from_dict(
        dict(scheduler_func="Linear")).scheduler == "Linear"


@pytest.mark.parametrize("start,stop,chunk", [(0, 16, 4), (2, 9, 8),
                                              (0, 16, 16)])
def test_adam_delta_matches_jax(start, stop, chunk):
    rng = np.random.default_rng(8)
    f, o, depth, cap, nt = 5, 3, 3, 16, 13
    cfg_j = JTreeConfig(input_dim=f, output_dim=o, n_num_features=f,
                        max_depth=depth)
    L, IN = 1 << depth, (1 << depth) - 1
    ens_j = j_init_ensemble(cfg_j, capacity=cap).replace(
        feat=jnp.asarray(rng.integers(-1, f, size=(cap, IN)).astype(np.int32)),
        thr=jnp.asarray(rng.normal(size=(cap, IN)).astype(np.float32)),
        is_split=jnp.asarray(rng.random((cap, IN)) > 0.3),
        leaf_values=jnp.asarray(rng.normal(size=(cap, L, o))
                                .astype(np.float32)),
        n_trees=jnp.asarray(nt, dtype=jnp.int32))
    X = rng.normal(size=(80, f)).astype(np.float32)
    spec = dict(algo="Adam", scheduler="Linear", init_lr=0.1, stop_lr=0.01,
                T=10, start_idx=1, stop_idx=3)
    want = jopt.adam_delta(cfg_j, ens_j, jnp.asarray(X),
                           jopt.OptimizerSpec(**spec), start, stop,
                           tree_chunk=chunk)
    cfg = TreeConfig(input_dim=f, output_dim=o, n_num_features=f,
                     max_depth=depth)
    ens = ensemble_from_numpy(j_to_numpy(ens_j), device="cpu")
    got = topt.adam_delta(cfg, ens, torch.from_numpy(X),
                          topt.OptimizerSpec(**spec), start, stop,
                          tree_chunk=chunk)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
