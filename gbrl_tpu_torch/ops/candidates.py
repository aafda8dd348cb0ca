"""Split-candidate generation on the tensors' device (counterpart of
``gbrl_tpu/ops/candidates.py``; reference
src/cpp/split_candidate_generator.cpp).

- Uniform (lines 59-76): per-feature ``min + b * (max - min) / n_bins`` for b
  in [0, n_bins).
- Quantile (lines 216-249): ``n_bins + 1`` equal-count bins over each
  feature's sorted values, the remainder spread one by one over the first
  bins; candidate b is the sorted value at cumulative_count - 1.

Both grids are bit-equal to the JAX package's.  The dense ``[F, n_bins]``
grid (ascending per feature) turns every ``x > candidate_b`` into
``bucket(x) > b`` with ``bucket = #{candidates < x}`` (``bucketize``, K1).
"""
from __future__ import annotations

from typing import Optional

import torch

from ..config import TreeConfig
from .kernels import bucketize_cuda


def uniform_candidates(X: torch.Tensor, n_bins: int,
                       mesh=None) -> torch.Tensor:
    """[N, F] -> [F, n_bins] (reference: split_candidate_generator.cpp:59-76).
    With a ``mesh`` the rows are this rank's and the extremes are taken
    over every rank's (exact)."""
    mx = torch.amax(X, dim=0)
    mn = torch.amin(X, dim=0)
    if mesh is not None:
        ext = mesh.gather_ranks(torch.stack([mx, mn]))       # [W, 2, F]
        mx = torch.amax(ext[:, 0], dim=0)
        mn = torch.amin(ext[:, 1], dim=0)
    step = (mx - mn) / float(n_bins)
    bins = torch.arange(n_bins, dtype=torch.float32, device=X.device)
    return mn[:, None] + bins[None, :] * step[:, None]


def quantile_index(n, n_bins: int, n_rows: int,
                   device: torch.device) -> torch.Tensor:
    """Sorted-row index of each quantile candidate: ``n_bins + 1`` bins of
    ``n // (n_bins + 1)`` rows, the remainder one each to the first bins,
    candidate b at ``cumsum(bin_counts)[b] - 1`` clipped to [0, n_rows)."""
    actual_bins = n_bins + 1
    j = torch.arange(actual_bins, device=device)
    bin_counts = n // actual_bins + (j < n % actual_bins).to(torch.int64)
    idx = torch.cumsum(bin_counts, dim=0)[:n_bins] - 1
    return torch.clamp(idx, 0, n_rows - 1)


def quantile_candidates(X: torch.Tensor, n_bins: int,
                        mesh=None) -> torch.Tensor:
    """[N, F] -> [F, n_bins] (reference: split_candidate_generator.cpp:216-249).
    With a ``mesh`` the rows are this rank's: every rank's rows are
    gathered in rank order (the global row order) and sorted, so the grid
    is the one a single process builds."""
    if mesh is not None:
        X = mesh.gather_ranks(X).reshape(-1, X.shape[1])
    n = X.shape[0]
    idx = quantile_index(n, n_bins, n, X.device)
    # stable, as the JAX package's sort: -0.0 and +0.0 keep their order
    Xs = torch.sort(X, dim=0, stable=True).values            # [N, F]
    return Xs[idx, :].T.contiguous()


def numerical_candidates(cfg: TreeConfig, X: torch.Tensor,
                         mesh=None) -> torch.Tensor:
    if cfg.generator == "uniform":
        return uniform_candidates(X, cfg.n_bins, mesh)
    return quantile_candidates(X, cfg.n_bins, mesh)


def bucketize(X: torch.Tensor, cand_vals: torch.Tensor) -> torch.Tensor:
    """Map samples to candidate buckets: [N, F], [F, B] -> [N, F] int32,
    ``bucket(x) = #{b : cand[f, b] < x}`` in [0, B] (B + 1 buckets), so
    ``x > cand[f, b] <=> bucket(x) > b``.  K1 on a CUDA tensor, its plain
    version on a CPU tensor."""
    return bucketize_cuda(X.contiguous(), cand_vals.contiguous())


def categorical_candidate_mask(Xc: torch.Tensor, grad_norms: torch.Tensor,
                               n_bins: int, n_codes: int,
                               sample_w: Optional[torch.Tensor] = None,
                               mesh=None) -> torch.Tensor:
    """Select categorical split candidates: [N, Fc] codes + [N] per-sample
    gradient norms -> valid mask [Fc, n_codes].

    Mirrors split_candidate_generator.cpp:117-163: every (feature, value)
    pair that appears is a candidate; if there are more than Fc * n_bins,
    the top ones by average gradient norm stay (top-k over ranks where
    absent pairs rank -inf).  ``sample_w`` masks padded rows out of the
    counts.  With a ``mesh`` the rows are this rank's and the per-pair sums
    are summed over the ranks.  Nothing here reads the device from the host
    and every shape comes from the arguments, so a CUDA graph can hold
    it."""
    N, Fc = Xc.shape
    dev = Xc.device
    if sample_w is None:
        sample_w = torch.ones((N,), dtype=torch.float32, device=dev)
    k = min(Fc * n_bins, Fc * n_codes)
    ids = torch.arange(Fc, device=dev)[None, :] * n_codes + Xc.long()
    data = torch.stack(
        [(grad_norms * sample_w)[:, None].expand(N, Fc),
         sample_w[:, None].expand(N, Fc)], dim=-1)
    agg = torch.zeros((Fc * n_codes, 2), dtype=torch.float32, device=dev)
    agg.index_add_(0, ids.reshape(-1), data.reshape(N * Fc, 2))
    if mesh is not None:
        agg = mesh.sum_ranks(agg)
    cnt = agg[:, 1]
    avg = torch.where(cnt > 0, agg[:, 0] / torch.clamp(cnt, min=1.0),
                      torch.full_like(cnt, float("-inf")))
    top_idx = torch.topk(avg, k).indices
    sel = torch.zeros((Fc * n_codes,), dtype=torch.bool, device=dev)
    sel.index_fill_(0, top_idx, True)
    return (sel & (cnt > 0)).reshape(Fc, n_codes)
