"""Boosting drivers (counterpart of ``gbrl_tpu/ops/boosting.py``).

Only the predict entry is ported so far; ``write_tree``, ``boost_step``,
``fit_loop`` and the control variates come with the fit path (ROADMAP.md,
slice 2).
"""
from __future__ import annotations

from typing import Optional, Sequence

import torch

from ..config import TreeConfig
from ..ensemble import Ensemble
from ..optimizers import OptimizerSpec, sgd_coeff
from .predict import weighted_leaf_sum


def predict_sgd(cfg: TreeConfig, ens: Ensemble, Xn: torch.Tensor,
                specs: Sequence[OptimizerSpec], start_tree: int,
                stop_tree: int,
                Xc: Optional[torch.Tensor] = None) -> torch.Tensor:
    """bias + sum of per-tree SGD updates over [start_tree, stop_tree)."""
    coeff = sgd_coeff(specs, ens.capacity, cfg.output_dim, ens.n_trees,
                      start_tree, stop_tree)
    return ens.bias[None, :] + weighted_leaf_sum(cfg, ens, Xn, coeff, Xc)
