"""K4/K5 CUDA kernels against their plain versions, on the card.

Marked ``cuda``: every test takes the ``cuda_device`` fixture, which skips
when PyTorch sees no CUDA device (CUDA kernels have no CPU mode).  Run on a
machine with an H100:
``python -m pytest tests/test_torch_kernels_cuda.py -q -m cuda``."""
import numpy as np
import pytest
import torch

from gbrl_tpu_torch.ops import kernels as K

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the predict kernels run only on "
                    "the card")
    return torch.device("cuda")


def _ensemble(rng, oblivious, T, F, O, D):
    IN, L = (1 << D) - 1, 1 << D
    if oblivious:
        feat = np.empty((T, IN), np.int32)
        thr = np.empty((T, IN), np.float32)
        spl = np.empty((T, IN), bool)
        for d in range(D):
            lo, k = (1 << d) - 1, 1 << d
            s = rng.random(T) > 0.2
            feat[:, lo:lo + k] = np.where(s, rng.integers(0, F, T), -1)[:, None]
            thr[:, lo:lo + k] = rng.normal(size=T)[:, None]
            spl[:, lo:lo + k] = s[:, None]
    else:
        feat = rng.integers(-1, F, (T, IN)).astype(np.int32)
        thr = rng.normal(size=(T, IN)).astype(np.float32)
        spl = rng.random((T, IN)) > 0.25
    w = rng.normal(size=(T, L, O)).astype(np.float32)
    return feat, thr, spl, w


@pytest.mark.parametrize("n,F,O,D,T,nt", [(4096, 16, 3, 4, 2048, 1600),
                                          (1000, 16, 3, 4, 256, 129),
                                          (37, 5, 11, 3, 16, 1),
                                          (100, 300, 2, 6, 64, 40),
                                          (300, 16, 3, 10, 24, 20),
                                          (64, 4, 2, 2, 8, 0)])
def test_kernels_match_plain(cuda_device, n, F, O, D, T, nt):
    rng = np.random.default_rng(n + D)
    for obl in (False, True):
        feat, thr, spl, w = _ensemble(rng, obl, T, F, O, D)
        X = rng.normal(size=(n, F)).astype(np.float32)
        X[: n // 4, max(feat[0, 0], 0)] = thr[0, 0]       # x == thr ties
        X[-1] = np.nan                                     # NaN goes left
        t = [torch.from_numpy(a).to(cuda_device) for a in (X, feat, thr, spl, w)]
        ntd = torch.tensor(nt, dtype=torch.int32, device=cuda_device)
        want = K.weighted_leaf_sum_plain(*t, D, nt)
        k4 = K.weighted_leaf_sum_cuda(*t, D, ntd)
        # the kernel sums the trees in another order than the plain
        # version: hold the error to 1e-5 of the output's scale
        err = (k4 - want).abs().max().item() if n else 0.0
        assert err <= 1e-5 * want.abs().max().item() + 1e-6, err
        if obl:
            k5 = K.oblivious_leaf_sum_cuda(*t, D, ntd)
            assert torch.equal(k5, k4)


def test_wrapper_rejects_bad_inputs(cuda_device):
    X = torch.zeros((4, 3), device=cuda_device)
    feat = torch.zeros((8, 7), dtype=torch.int32, device=cuda_device)
    thr = torch.zeros((8, 7), device=cuda_device)
    spl = torch.zeros((8, 7), dtype=torch.bool, device=cuda_device)
    w = torch.zeros((8, 8, 2), device=cuda_device)
    nt = torch.tensor(8, dtype=torch.int32, device=cuda_device)
    with pytest.raises(ValueError):
        K.weighted_leaf_sum_cuda(X, feat.float(), thr, spl, w, 3, nt)
    with pytest.raises(ValueError):
        K.weighted_leaf_sum_cuda(X.t(), feat, thr, spl, w, 3, nt)
    with pytest.raises(ValueError):
        K.oblivious_leaf_sum_cuda(X, feat, thr, spl, w, 3, nt.cpu())


def test_wrapper_raises_past_shared_memory_ceiling(cuda_device):
    """K4 at depth 12 needs more shared memory than a block can hold even
    at the smallest chunk: the wrapper raises, it does not fall back."""
    D, T = 12, 8
    IN, L = (1 << D) - 1, 1 << D
    X = torch.zeros((4, 3), device=cuda_device)
    feat = torch.zeros((T, IN), dtype=torch.int32, device=cuda_device)
    thr = torch.zeros((T, IN), device=cuda_device)
    spl = torch.zeros((T, IN), dtype=torch.bool, device=cuda_device)
    w = torch.zeros((T, L, 3), device=cuda_device)
    nt = torch.tensor(T, dtype=torch.int32, device=cuda_device)
    with pytest.raises(ValueError, match="shared memory"):
        K.weighted_leaf_sum_cuda(X, feat, thr, spl, w, D, nt)
