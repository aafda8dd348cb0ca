"""MultiRMSE loss (counterpart of ``gbrl_tpu/ops/loss.py``; the only loss in
the reference, src/cpp/loss.cpp:34-90).

grad = pred - target;  loss = sqrt(0.5 * sum((pred-target)^2) / n_samples).
``sample_w`` is a 0/1 row mask for padded batches.
"""
from __future__ import annotations

from typing import Tuple

import torch


def multirmse_grads(preds: torch.Tensor, targets: torch.Tensor,
                    sample_w: torch.Tensor, mesh=None
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns (grads [N, O], loss scalar tensor).  With a ``mesh``
    (parallel/sharded.py) the rows are this rank's and the loss is the
    global one: sum(g^2) and the row count summed over the ranks."""
    g = (preds - targets) * sample_w[:, None]
    s = torch.stack([torch.sum(g * g), torch.sum(sample_w)])
    if mesh is not None:
        s = mesh.sum_ranks(s)
    return g, torch.sqrt(0.5 * s[0] / torch.clamp(s[1], min=1.0))


def multirmse_loss(preds: torch.Tensor, targets: torch.Tensor,
                   sample_w: torch.Tensor) -> torch.Tensor:
    return multirmse_grads(preds, targets, sample_w)[1]
