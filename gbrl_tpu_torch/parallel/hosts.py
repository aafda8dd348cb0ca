"""Multi-process entry points for data-parallel boosting (counterpart of
``gbrl_tpu/parallel/hosts.py``).

The JAX package boots ``jax.distributed`` so that one mesh spans every
host's devices.  Here each process is one rank of a ``torch.distributed``
process group: ``initialize`` starts it from explicit arguments or from the
variables torchrun sets (``MASTER_ADDR``, ``MASTER_PORT``, ``WORLD_SIZE``,
``RANK``); ``host_array`` places this process's shard of a global array on
its device (shards are concatenated in rank order and must be equal, as
the JAX package's even sharding requires); the ``host_*`` steps take only
this process's rows, as numpy, and run the sharded steps of
``parallel/sharded.py`` and ``parallel/sharded_rl.py``, so every process
ends each step with a bit-identical ensemble.

    initialize(device="cuda")        # torchrun's variables
    mesh = global_mesh()
    ens = replicate(mesh, init_ensemble(cfg, device="cpu"))
    ens, loss = host_train_step(cfg, mesh, ens, X_local, y_local, fw, specs)
    shutdown()
"""
from __future__ import annotations

import os
from typing import Optional, Tuple, Union

import numpy as np
import torch
import torch.distributed as dist

from ..common.utils import resolve_device
from ..config import TreeConfig
from ..ensemble import Ensemble
from ..optimizers import OptimizerSpec
from . import sharded
from .sharded import Mesh, make_mesh, sharded_boost_step, sharded_train_step
from .sharded_rl import sharded_awr_update, sharded_ppo_update

_ENV = ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK")
# the device ``initialize`` was given, for ``global_mesh``
_device: Optional[torch.device] = None


def initialize(address: Optional[str] = None,
               world_size: Optional[int] = None,
               rank: Optional[int] = None,
               backend: Optional[str] = None,
               device: Union[str, torch.device, None] = None) -> None:
    """Join the process group.  ``address`` ("tcp://host:port" or
    "host:port"), ``world_size`` and ``rank`` default to torchrun's
    ``MASTER_ADDR`` / ``MASTER_PORT``, ``WORLD_SIZE`` and ``RANK``.  The
    device is "cuda" unless the caller asks for the CPU (a CUDA request
    without a card raises); the backend is NCCL for a CUDA device and gloo
    for the CPU (gloo on CUDA tensors when asked for).  A second call does
    nothing."""
    global _device
    if dist.is_initialized():
        return
    dev = resolve_device("cuda" if device is None else device)
    env = os.environ
    if address is None:
        if "MASTER_ADDR" not in env or "MASTER_PORT" not in env:
            raise ValueError("no address: pass address= or set MASTER_ADDR "
                             "and MASTER_PORT (torchrun sets them)")
        address = f"{env['MASTER_ADDR']}:{env['MASTER_PORT']}"
    if "://" not in address:
        address = "tcp://" + address
    for name, val in (("WORLD_SIZE", world_size), ("RANK", rank)):
        if val is None and name not in env:
            raise ValueError(f"pass {name.lower()}= or set {name} "
                             "(torchrun sets it)")
    world_size = int(env["WORLD_SIZE"]) if world_size is None else world_size
    rank = int(env["RANK"]) if rank is None else rank
    if backend is None:
        backend = "nccl" if dev.type == "cuda" else "gloo"
    if dev.type == "cuda" and dev.index is not None:
        torch.cuda.set_device(dev)
    dist.init_process_group(backend, init_method=address,
                            world_size=world_size, rank=rank)
    _device = dev


def shutdown() -> None:
    """Leave the process group (call at process exit)."""
    global _device
    if dist.is_initialized():
        dist.destroy_process_group()
    _device = None


def global_mesh() -> Mesh:
    """The data-parallel mesh over every rank, on the device ``initialize``
    was given."""
    if not dist.is_initialized():
        raise RuntimeError("call hosts.initialize() first")
    return make_mesh(dist.group.WORLD, _device)


def host_array(mesh: Mesh, local_data) -> torch.Tensor:
    """This process's ``[N_local, ...]`` shard of a global array, on its
    device.  Shards are concatenated in rank order; every rank's must have
    the same number of rows (checked with one gather of the row counts)."""
    t = torch.as_tensor(np.ascontiguousarray(local_data)).to(mesh.device)
    n = torch.tensor([t.shape[0]], dtype=torch.int64, device=mesh.device)
    counts = mesh.gather_ranks(n).reshape(-1).tolist()
    if len(set(counts)) != 1:
        raise ValueError(f"uneven shards over the ranks: {counts} rows; "
                         "the data must shard evenly")
    return t


# every rank starts from rank 0's ensemble: the package's one replicate
replicate = sharded.replicate


def _feat_w(mesh: Mesh, feat_w) -> torch.Tensor:
    return torch.as_tensor(feat_w if torch.is_tensor(feat_w)
                           else np.asarray(feat_w, np.float32)
                           ).to(mesh.device, torch.float32)


def host_boost_step(cfg: TreeConfig, mesh: Mesh, ens: Ensemble,
                    Xn_local: np.ndarray, grads_local: np.ndarray,
                    feat_w) -> Ensemble:
    """One boosting iteration from per-process shards: each process passes
    only its [N_local, F] observations and gradients; the fitted tree is
    the same on every process."""
    data = host_array(mesh, np.concatenate(
        [np.asarray(Xn_local, np.float32), np.asarray(grads_local, np.float32)],
        axis=1))
    F = np.shape(Xn_local)[1]
    return sharded_boost_step(cfg, mesh, ens, data[:, :F].contiguous(),
                              data[:, F:].contiguous(), _feat_w(mesh, feat_w))


def host_train_step(cfg: TreeConfig, mesh: Mesh, ens: Ensemble,
                    Xn_local: np.ndarray, targets_local: np.ndarray,
                    feat_w, specs: Tuple[OptimizerSpec, ...]):
    """Supervised predict -> grads -> fit step from per-process shards.
    Returns (ensemble, loss); the loss is the global MultiRMSE over every
    process's rows, a device tensor."""
    data = host_array(mesh, np.concatenate(
        [np.asarray(Xn_local, np.float32),
         np.asarray(targets_local, np.float32)], axis=1))
    F = np.shape(Xn_local)[1]
    return sharded_train_step(cfg, mesh, ens, data[:, :F].contiguous(),
                              data[:, F:].contiguous(),
                              _feat_w(mesh, feat_w), specs)


def host_ppo_update(cfg: TreeConfig, hp, mesh: Mesh, ens: Ensemble,
                    X_local: np.ndarray, mb_idx, mb_n,
                    actions_local: np.ndarray, old_logp_local: np.ndarray,
                    adv_local: np.ndarray, ret_local: np.ndarray,
                    specs: Tuple[OptimizerSpec, ...], feat_w,
                    valid_local: Optional[np.ndarray] = None,
                    n_trees0: Optional[int] = None):
    """PPO update phase fed by per-process rollout shards.  Each process
    runs its own envs and passes only its rollout slice; ``mb_idx`` /
    ``mb_n`` (the minibatch plan over global row indices) must be drawn
    with the same seed on every process.  ``valid_local`` masks autoreset
    rows (rl/buffers.py ``flat``); ``n_trees0`` is the ensemble's tree
    count as a host int (read from the device when None).  Returns
    (ensemble, entropy trace), bit-identical across processes."""
    X_local = np.asarray(X_local, np.float32)
    B, F = X_local.shape
    if valid_local is None:
        valid_local = np.ones((B,), np.float32)
    cols = [np.asarray(c, np.float32).reshape(B, 1) for c in (
        actions_local, old_logp_local, adv_local, ret_local, valid_local)]
    data = host_array(mesh, np.concatenate([X_local] + cols, axis=1))
    X, a, lp, adv, ret, valid = (data[:, :F].contiguous(),) + tuple(
        data[:, F + i].contiguous() for i in range(5))
    return sharded_ppo_update(cfg, hp, mesh, ens, X, mb_idx, mb_n,
                              a.to(torch.int64), lp, adv, ret, specs,
                              _feat_w(mesh, feat_w), valid, n_trees0)


def host_awr_update(acfg: TreeConfig, ccfg: TreeConfig, hp, mesh: Mesh,
                    actor_ens: Ensemble, critic_ens: Ensemble,
                    X_local: np.ndarray, acts_local: np.ndarray,
                    rets_local: np.ndarray, advs_local: np.ndarray,
                    cmb_idx: np.ndarray, amb_idx: np.ndarray,
                    specs, feat_w):
    """AWR update phase fed by per-process replay shards (valid rows only,
    already advantage-annotated); ``cmb_idx`` / ``amb_idx`` (the critic and
    actor minibatch plans over global row indices) must be drawn with the
    same seed on every process.  Returns (actor_ens, critic_ens, traces),
    bit-identical across processes."""
    X_local = np.asarray(X_local, np.float32)
    B, F = X_local.shape
    A = hp.act_dim
    data = host_array(mesh, np.concatenate(
        [X_local, np.asarray(acts_local, np.float32).reshape(B, A),
         np.asarray(rets_local, np.float32).reshape(B, 1),
         np.asarray(advs_local, np.float32).reshape(B, 1)], axis=1))
    return sharded_awr_update(
        acfg, ccfg, hp, mesh, actor_ens, critic_ens,
        data[:, :F].contiguous(), data[:, F:F + A].contiguous(),
        data[:, F + A].contiguous(), data[:, F + A + 1].contiguous(),
        cmb_idx, amb_idx, tuple(specs), _feat_w(mesh, feat_w))
