"""Ensemble storage: structure-of-arrays of perfect binary trees, as torch
tensors (counterpart of ``gbrl_tpu/ensemble.py``, same fields, dtypes and
heap layout).

- heap node ``p`` has children ``2p+1`` (left / condition false) and ``2p+2``
  (right / condition true);
- a node that the fitter did not split is a *pass-through*: samples always
  descend left, so the value of such a leaf-node lives at the left-most leaf
  slot of its subtree.

Numeric ``x > threshold`` routes right, categorical ``code == split_code``
routes right (reference node.cpp:77-96).  Capacity grows geometrically.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict

import numpy as np
import torch

from .common.utils import resolve_device
from .config import TreeConfig

DEFAULT_INITIAL_CAPACITY = 1024
FIELDS = ("feat", "thr", "cat_code", "is_split", "is_numeric", "leaf_values",
          "counts", "depths", "bias", "n_trees")


@dataclasses.dataclass
class Ensemble:
    """SoA ensemble of perfect binary trees, all tensors on one device.

    Shapes (T = tree capacity, NODES = 2^D - 1, LEAVES = 2^D, O = output_dim):

    - feat        [T, NODES] int32 : split feature (numeric block index, or
                                     categorical block index when is_numeric
                                     is False); -1 on pass-through nodes.
    - thr         [T, NODES] f32   : numeric threshold (x > thr -> right).
    - cat_code    [T, NODES] int32 : categorical code (x == code -> right).
    - is_split    [T, NODES] bool  : whether the node splits.
    - is_numeric  [T, NODES] bool  : numeric vs categorical condition.
    - leaf_values [T, LEAVES, O] f32 : mean gradient of routed samples.
    - counts      [T, 2*LEAVES-1] f32 : samples seen per heap node at fit
                                        time (root=0).
    - depths      [T] int32 : deepest split level + 1 of the tree.
    - bias        [O] f32   : ensemble bias.
    - n_trees     [] int32  : number of fitted trees, kept on the device so
                              the predict kernels read it without a host
                              round trip.
    """
    feat: torch.Tensor
    thr: torch.Tensor
    cat_code: torch.Tensor
    is_split: torch.Tensor
    is_numeric: torch.Tensor
    leaf_values: torch.Tensor
    counts: torch.Tensor
    depths: torch.Tensor
    bias: torch.Tensor
    n_trees: torch.Tensor

    @property
    def capacity(self) -> int:
        return self.feat.shape[0]

    @property
    def output_dim(self) -> int:
        return self.leaf_values.shape[-1]

    @property
    def device(self) -> torch.device:
        return self.feat.device

    def replace(self, **kw) -> "Ensemble":
        return dataclasses.replace(self, **kw)


def init_ensemble(cfg: TreeConfig, capacity: int = DEFAULT_INITIAL_CAPACITY,
                  device: str = "cuda") -> Ensemble:
    dev = resolve_device(device)
    nodes, leaves, out = cfg.n_nodes, cfg.n_leaves, cfg.output_dim

    def full(shape, fill, dtype):
        return torch.full(shape, fill, dtype=dtype, device=dev)

    return Ensemble(
        feat=full((capacity, nodes), -1, torch.int32),
        thr=full((capacity, nodes), 0.0, torch.float32),
        cat_code=full((capacity, nodes), -1, torch.int32),
        is_split=full((capacity, nodes), False, torch.bool),
        is_numeric=full((capacity, nodes), True, torch.bool),
        leaf_values=full((capacity, leaves, out), 0.0, torch.float32),
        counts=full((capacity, 2 * leaves - 1), 0.0, torch.float32),
        depths=full((capacity,), 0, torch.int32),
        bias=full((out,), 0.0, torch.float32),
        n_trees=full((), 0, torch.int32),
    )


def grow_ensemble(ens: Ensemble, new_capacity: int) -> Ensemble:
    """Grow tree capacity, filling new slots as ``init_ensemble`` does."""
    if new_capacity <= ens.capacity:
        return ens
    extra = new_capacity - ens.capacity

    def pad(x, fill):
        tail = torch.full((extra,) + tuple(x.shape[1:]), fill, dtype=x.dtype,
                          device=x.device)
        return torch.cat([x, tail], dim=0)

    return ens.replace(
        feat=pad(ens.feat, -1),
        thr=pad(ens.thr, 0.0),
        cat_code=pad(ens.cat_code, -1),
        is_split=pad(ens.is_split, False),
        is_numeric=pad(ens.is_numeric, True),
        leaf_values=pad(ens.leaf_values, 0.0),
        counts=pad(ens.counts, 0.0),
        depths=pad(ens.depths, 0),
    )


def ensure_capacity(ens: Ensemble, needed: int) -> Ensemble:
    if needed <= ens.capacity:
        return ens
    cap = max(ens.capacity, 1)
    while cap < needed:
        cap *= 2
    return grow_ensemble(ens, cap)


def ensemble_to_numpy(ens: Ensemble) -> Dict[str, np.ndarray]:
    """The same dict as ``gbrl_tpu.ensemble.ensemble_to_numpy``."""
    return {f: v.detach().cpu().numpy() for f, v in vars_dict(ens).items()}


def vars_dict(ens: Ensemble) -> Dict[str, Any]:
    """The ensemble's fields by name, as tensors on its device."""
    return {f: getattr(ens, f) for f in FIELDS}


def host_arrays(ens) -> Dict[str, np.ndarray]:
    """An ``Ensemble``'s fields copied to the host in one go (one copy per
    field, never per tree); a dict of numpy arrays is returned as it is."""
    return ens if isinstance(ens, dict) else ensemble_to_numpy(ens)


def ensemble_from_numpy(arrs: Dict[str, np.ndarray],
                        device: str = "cuda") -> Ensemble:
    """Inverse of ``ensemble_to_numpy`` (also takes the JAX package's dict)."""
    dev = resolve_device(device)
    return Ensemble(**{f: torch.tensor(np.asarray(arrs[f]), device=dev)
                       for f in FIELDS})
