"""Data-parallel boosting over ``torch.distributed`` (counterpart of
``gbrl_tpu/parallel/sharded.py``).

One process per rank, as PyTorch runs it.  Samples shard over the ranks;
the ensemble is replicated.  Each rank bins its own rows (K1 against the
global candidate grid) and builds the partial (feature, node, bucket)
gradient histogram of its rows (K2); the histograms are summed over the
ranks between K2 and K3, so split selection (K3), routing and the tree
written into the ensemble are the same on every rank.  The other
cross-sample quantities of one boosting step ride the same sum: the
control-variate and L2 standardisation moments, the categorical candidate
counts, the node and leaf sums, and the MultiRMSE loss; the quantile grid
gathers every rank's rows in rank order (the global row order), so it is the
grid one process would build.

Where JAX lets XLA place the collectives, here the fit path takes an
optional ``mesh`` argument (``ops/boosting.py``, ``ops/fit.py``,
``ops/candidates.py``, ``ops/loss.py``) and calls two primitives of
``Mesh``:

- ``gather_ranks(t)`` -> ``[W, *t.shape]``, every rank's ``t`` in rank
  order, the exact bits;
- ``sum_ranks(t)`` -> ``parts[0] + parts[1] + ...``, added left to right in
  rank order on every rank.

So every rank gets bit-identical results whatever the backend's reduction
order, and a world of 1 is the identity, bit for bit.  NCCL gathers with
``all_gather_into_tensor``.  Gloo runs ``all_gather`` on CPU tensors only,
so there each rank writes its ``t`` into its own slot of a zeroed
``[W, ...]`` buffer and the buffer's raw bits, viewed as integers, are
summed with one ``all_reduce``: every other slot adds 0, so each slot
arrives with its owner's exact bits (``-0.0`` and NaN included).  Both
routes give the same bits.  NCCL cannot place two ranks on one card; gloo
can, on CUDA tensors too, and then every collective waits for the host.

The whole-tree kernel K6 fits a tree in one launch, with no place for a
collective between its levels: asking for it (``ops.fit._DISABLE_FUSED_TREE
= False``) while samples are sharded over more than one rank raises.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple, Union

import numpy as np
import torch
import torch.distributed as dist

from ..common.utils import resolve_device
from ..config import TreeConfig
from ..ensemble import FIELDS, Ensemble
from ..ops.boosting import boost_step, predict_sgd
from ..ops.loss import multirmse_grads
from ..optimizers import OptimizerSpec

_BIT_VIEWS = {1: torch.uint8, 4: torch.int32, 8: torch.int64}


def _bits(t: torch.Tensor) -> torch.Tensor:
    """A flat integer view of a contiguous tensor's bytes (an integer sum
    with zeros is exact, a float one turns -0.0 into +0.0)."""
    view = _BIT_VIEWS.get(t.element_size())
    if view is None:
        raise TypeError(f"no collective for {t.dtype}")
    return t.reshape(-1).view(view)


@dataclasses.dataclass
class Mesh:
    """This process's place among the ranks: its rank, the world size, its
    device and the process group (None: a world of 1 with no collective).
    ``collectives`` counts the collectives issued through it."""
    rank: int
    world: int
    device: torch.device
    group: Optional[dist.ProcessGroup] = None
    collectives: int = 0

    @property
    def backend(self) -> Optional[str]:
        return None if self.group is None else dist.get_backend(self.group)

    def gather_ranks(self, t: torch.Tensor) -> torch.Tensor:
        """``[W, *t.shape]``: every rank's ``t`` in rank order, exact."""
        t = t.contiguous()
        if self.group is None:
            return t[None]
        out = torch.zeros((self.world,) + tuple(t.shape), dtype=t.dtype,
                          device=t.device)
        self.collectives += 1
        if self.backend == "nccl":
            dist.all_gather_into_tensor(out, t, group=self.group)
        else:
            out[self.rank] = t
            dist.all_reduce(_bits(out), group=self.group)
        return out

    def sum_ranks(self, t: torch.Tensor) -> torch.Tensor:
        """``parts[0] + parts[1] + ...`` in rank order: the same bits on
        every rank, ``t``'s own bits in a world of 1."""
        parts = self.gather_ranks(t)
        s = parts[0]
        for p in parts[1:]:
            s = s + p
        return s

    def broadcast(self, t: torch.Tensor) -> torch.Tensor:
        """``t`` (contiguous, on this device) overwritten in place with
        rank 0's."""
        if self.group is not None:
            self.collectives += 1
            dist.broadcast(_bits(t), src=dist.get_global_rank(self.group, 0),
                           group=self.group)
        return t


def make_mesh(group: Optional[dist.ProcessGroup] = None,
              device: Union[str, torch.device, None] = None) -> Mesh:
    """The mesh of ``group`` (the default group when ``torch.distributed``
    is initialised and none is given; else a world of 1 with no group) on
    ``device`` ("cuda" unless the caller asks for the CPU; a CUDA request
    without a card raises)."""
    dev = resolve_device("cuda" if device is None else device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    if group is None and dist.is_available() and dist.is_initialized():
        group = dist.group.WORLD
    if group is None:
        return Mesh(0, 1, dev)
    return Mesh(dist.get_rank(group), dist.get_world_size(group), dev, group)


def shard_batch(mesh: Mesh, x) -> torch.Tensor:
    """This rank's rows of a ``[N, ...]`` array that every rank holds
    (N must divide evenly over the ranks), on the rank's device."""
    x = x if torch.is_tensor(x) else torch.as_tensor(np.asarray(x))
    n = x.shape[0]
    if n % mesh.world:
        raise ValueError(f"{n} rows do not shard evenly over {mesh.world} "
                         "ranks")
    k = n // mesh.world
    return x[mesh.rank * k:(mesh.rank + 1) * k].to(mesh.device).contiguous()


def replicate(mesh: Mesh, tree):
    """An ensemble (or one array) on the rank's device, every field
    broadcast from rank 0."""
    if isinstance(tree, Ensemble):
        return tree.replace(**{f: replicate(mesh, getattr(tree, f))
                               for f in FIELDS})
    t = tree if torch.is_tensor(tree) else torch.as_tensor(np.asarray(tree))
    return mesh.broadcast(t.to(mesh.device, copy=True).contiguous())


def _check_rows(mesh: Mesh, *arrays) -> None:
    for a in arrays:
        if a is not None and a.device != mesh.device:
            raise ValueError(f"a {tuple(a.shape)} shard lies on {a.device}, "
                             f"the mesh's device is {mesh.device}")


def sharded_boost_step(cfg: TreeConfig, mesh: Mesh, ens: Ensemble,
                       Xn: torch.Tensor, grads: torch.Tensor,
                       feat_w: torch.Tensor,
                       Xc: Optional[torch.Tensor] = None,
                       feat_w_cat: Optional[torch.Tensor] = None,
                       n_codes: int = 0) -> Ensemble:
    """One boosting iteration with samples sharded over the mesh: ``Xn``,
    ``grads`` (and ``Xc``) are this rank's rows; the returned ensemble is
    the same on every rank."""
    _check_rows(mesh, Xn, grads, Xc)
    return boost_step(cfg, ens, Xn, grads, feat_w, Xc, feat_w_cat, n_codes,
                      mesh=mesh)


def sharded_train_step(cfg: TreeConfig, mesh: Mesh, ens: Ensemble,
                       Xn: torch.Tensor, targets: torch.Tensor,
                       feat_w: torch.Tensor,
                       specs: Tuple[OptimizerSpec, ...],
                       Xc: Optional[torch.Tensor] = None,
                       feat_w_cat: Optional[torch.Tensor] = None,
                       n_codes: int = 0) -> Tuple[Ensemble, torch.Tensor]:
    """predict (K4 / K5 on this rank's rows) -> MultiRMSE gradients with
    the global loss -> one boosting step.  Returns (ensemble, loss), the
    loss a device tensor, both the same on every rank."""
    _check_rows(mesh, Xn, targets, Xc)
    w = torch.ones((targets.shape[0],), dtype=torch.float32,
                   device=targets.device)
    preds = predict_sgd(cfg, ens, Xn, specs, 0, ens.n_trees, Xc)
    grads, loss = multirmse_grads(preds, targets, w, mesh=mesh)
    return boost_step(cfg, ens, Xn, grads, feat_w, Xc, feat_w_cat, n_codes,
                      mesh=mesh), loss
