"""MultiRMSE loss (counterpart of ``gbrl_tpu/ops/loss.py``; the only loss in
the reference, src/cpp/loss.cpp:34-90).

grad = pred - target;  loss = sqrt(0.5 * sum((pred-target)^2) / n_samples).
``sample_w`` is a 0/1 row mask for padded batches.
"""
from __future__ import annotations

from typing import Tuple

import torch


def multirmse_grads(preds: torch.Tensor, targets: torch.Tensor,
                    sample_w: torch.Tensor) -> Tuple[torch.Tensor,
                                                     torch.Tensor]:
    """Returns (grads [N, O], loss scalar tensor)."""
    g = (preds - targets) * sample_w[:, None]
    n = torch.clamp(torch.sum(sample_w), min=1.0)
    return g, torch.sqrt(0.5 * torch.sum(g * g) / n)


def multirmse_loss(preds: torch.Tensor, targets: torch.Tensor,
                   sample_w: torch.Tensor) -> torch.Tensor:
    return multirmse_grads(preds, targets, sample_w)[1]
