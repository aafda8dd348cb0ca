"""The port's device SHAP on the card against the same call on the CPU port.

Marked ``cuda``: every test takes the ``cuda_device`` fixture, which skips
when PyTorch sees no CUDA device.  Run on a machine with an NVIDIA GPU:
``python -m pytest tests/test_torch_shap_cuda.py -q -m cuda``."""
import numpy as np
import pytest
import torch

from gbrl_tpu_torch.config import TreeConfig
from gbrl_tpu_torch.ensemble import ensemble_from_numpy
from gbrl_tpu_torch.ops.shap_device import ensemble_shap_device

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the card's SHAP runs only there")
    return torch.device("cuda")


def _ensemble(rng, policy, fn, fc, o, depth, cap, n_trees):
    """Random trees over the whole capacity (slots past n_trees hold finite
    junk that must never count): numeric nodes index the numeric block,
    categorical ones the categorical block; counts include zeros."""
    IN, L = (1 << depth) - 1, 1 << depth
    spl = rng.random((cap, IN)) > 0.2
    num = rng.random((cap, IN)) < (fn / (fn + fc))
    if policy == "oblivious":          # one condition per level
        for d in range(depth):
            lo, k = (1 << d) - 1, 1 << d
            spl[:, lo:lo + k] = spl[:, lo:lo + 1]
            num[:, lo:lo + k] = num[:, lo:lo + 1]
    feat = np.where(num, rng.integers(0, max(fn, 1), (cap, IN)),
                    rng.integers(0, max(fc, 1), (cap, IN))).astype(np.int32)
    if policy == "oblivious":
        for d in range(depth):
            lo, k = (1 << d) - 1, 1 << d
            feat[:, lo:lo + k] = feat[:, lo:lo + 1]
    counts = rng.uniform(0.5, 50, (cap, 2 * L - 1)).astype(np.float32)
    counts[rng.random(counts.shape) < 0.05] = 0.0
    return dict(
        feat=feat, thr=rng.normal(size=(cap, IN)).astype(np.float32),
        cat_code=rng.integers(0, 4, (cap, IN)).astype(np.int32),
        is_split=spl, is_numeric=num,
        leaf_values=rng.normal(size=(cap, L, o)).astype(np.float32),
        counts=counts, depths=np.full((cap,), depth, np.int32),
        bias=np.zeros(o, np.float32), n_trees=np.asarray(n_trees, np.int32))


@pytest.mark.parametrize("n,fn,fc,o,depth,cap,n_trees", [
    (4096, 16, 0, 3, 4, 512, 400),      # the PPO shared actor-critic shape
    (1000, 1, 3, 2, 3, 64, 40),         # more categorical than numeric
    (257, 5, 2, 1, 6, 16, 9),           # deep, one output
    (33, 0, 4, 2, 2, 8, 8)])            # categorical only, full capacity
@pytest.mark.parametrize("policy", ["greedy", "oblivious"])
def test_card_shap_matches_cpu(cuda_device, policy, n, fn, fc, o, depth, cap,
                               n_trees):
    rng = np.random.default_rng(n + depth)
    arrs = _ensemble(rng, policy, fn, fc, o, depth, cap, n_trees)
    cfg = TreeConfig(input_dim=fn + fc, output_dim=o, n_num_features=fn,
                     n_cat_features=fc, max_depth=depth, grow_policy=policy)
    Xn = torch.from_numpy(rng.normal(size=(n, fn)).astype(np.float32))
    Xc = (torch.from_numpy(rng.integers(-1, 5, (n, fc)).astype(np.int32))
          if fc else None)
    want = ensemble_shap_device(cfg, ensemble_from_numpy(arrs, "cpu"), Xn, Xc,
                                fn + fc)
    got = ensemble_shap_device(
        cfg, ensemble_from_numpy(arrs, "cuda"), Xn.to(cuda_device),
        None if Xc is None else Xc.to(cuda_device), fn + fc)
    assert got.device.type == "cuda" and got.shape == (n, fn + fc, o)
    assert torch.isfinite(got).all()
    lim = 1e-5 * want.abs().max().item() + 1e-6
    assert (got.cpu() - want).abs().max().item() <= lim
    one = ensemble_shap_device(
        cfg, ensemble_from_numpy(arrs, "cuda"), Xn.to(cuda_device),
        None if Xc is None else Xc.to(cuda_device), fn + fc, 1)
    want1 = ensemble_shap_device(cfg, ensemble_from_numpy(arrs, "cpu"), Xn,
                                 Xc, fn + fc, 1)
    assert (one.cpu() - want1).abs().max().item() <= \
        1e-5 * want1.abs().max().item() + 1e-6
