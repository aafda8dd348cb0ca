"""Leaf-value optimizers and schedulers (lr applied at *prediction* time).

Counterpart of ``gbrl_tpu/optimizers.py``.  Leaves store mean gradients and
prediction applies per-tree optimizer updates
``theta[start_idx:stop_idx] -= lr(t) * leaf_value`` (SGD, reference
optimizer.cpp:110-118) or bias-corrected Adam with per-(sample, column) m/v
state accumulated over the tree sequence (optimizer.cpp:260-283).

- SGD + Const/Linear collapses to a dense coefficient matrix
  ``coeff[t, j] = -lr_o(t)`` on each optimizer's column range, consumed by
  one weighted leaf reduction (ops/predict.weighted_leaf_sum).
- Adam is a per-sample linear recurrence over trees, evaluated in closed
  form per tree chunk with exponent-shifted cumulative sums, in plain torch
  on the ensemble's device.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Sequence

import torch

from .config import TreeConfig
from .ensemble import Ensemble
from .ops.predict import DEFAULT_TREE_CHUNK, _chunk_size, chunk_leaf_rel
from .utils import profiling


@dataclasses.dataclass(frozen=True)
class OptimizerSpec:
    """Host-side optimizer configuration (reference: optimizerConfig)."""
    algo: str = "SGD"               # 'SGD' | 'Adam'
    scheduler: str = "Const"        # 'Const' | 'Linear'
    init_lr: float = 1.0
    stop_lr: float = 1.0e-4
    T: int = 10000
    start_idx: int = 0
    stop_idx: int = 0
    beta_1: float = 0.9
    beta_2: float = 0.999
    eps: float = 1.0e-8

    def to_dict(self) -> Dict:
        return dataclasses.asdict(self)

    @staticmethod
    def from_dict(d: Dict) -> "OptimizerSpec":
        d = dict(d)
        # accept the model-facade conventions: 'lr' (incl. the 'lin_<lr>'
        # Linear-scheduler string) and the reference binding's
        # 'scheduler_func' key
        if "init_lr" not in d and "lr" in d:
            lr = d["lr"]
            if isinstance(lr, str) and lr.startswith("lin_"):
                d["scheduler"] = "Linear"
                lr = lr[len("lin_"):]
            d["init_lr"] = float(lr)
        if "scheduler" not in d and "scheduler_func" in d:
            d["scheduler"] = d["scheduler_func"]
        fields = {f.name for f in dataclasses.fields(OptimizerSpec)}
        return OptimizerSpec(**{k: v for k, v in d.items() if k in fields})


def scheduler_lr(spec: OptimizerSpec, t: torch.Tensor) -> torch.Tensor:
    """lr(t) in f32 for integer tree indices t (scheduler.h:124-133, 182-185).

    Linear: t_ = t+1; lr = init + (t_/T)*(stop-init), floored at stop_lr.
    """
    t = t.to(torch.float32)
    if spec.scheduler == "Linear":
        T = float(spec.T)
        t_ = t + 1.0
        progress_remaining = (T - t_) / T
        lr = spec.init_lr + (1.0 - progress_remaining) * (
            spec.stop_lr - spec.init_lr)
        return torch.where(lr < spec.stop_lr,
                           torch.full_like(lr, spec.stop_lr), lr)
    return torch.full_like(t, spec.init_lr)


def _col_mask(spec: OptimizerSpec, output_dim: int,
              device: torch.device) -> torch.Tensor:
    j = torch.arange(output_dim, device=device)
    return ((j >= spec.start_idx) & (j < spec.stop_idx)).to(torch.float32)


def sgd_coeff(specs: Sequence[OptimizerSpec], capacity: int, output_dim: int,
              n_trees: torch.Tensor, start_tree: int,
              stop_tree: int) -> torch.Tensor:
    """[T_cap, O] coefficient matrix on ``n_trees``' device: -lr_o(t) on
    each SGD optimizer's columns, zero outside [start_tree, stop_tree) and
    beyond n_trees (compared on the device: no host round trip)."""
    dev = n_trees.device
    t = torch.arange(capacity, dtype=torch.int32, device=dev)
    active = (t >= start_tree) & (t < stop_tree) & (t < n_trees)
    coeff = torch.zeros((capacity, output_dim), dtype=torch.float32,
                        device=dev)
    for spec in specs:
        if spec.algo != "SGD":
            continue
        lr = scheduler_lr(spec, t) * active.to(torch.float32)
        coeff = coeff - lr[:, None] * _col_mask(spec, output_dim, dev)[None, :]
    return coeff


def adam_delta(cfg: TreeConfig, ens: Ensemble, Xn: torch.Tensor,
               spec: OptimizerSpec, start_tree: int, stop_tree: int,
               Xc: Optional[torch.Tensor] = None,
               tree_chunk: int = DEFAULT_TREE_CHUNK) -> torch.Tensor:
    """Accumulated Adam update sum_t alpha_t * m_t / (sqrt(v_t)+eps) over the
    optimizer's columns -> [N, O] (to be *subtracted* from theta).

    The reference recurrence (optimizer.cpp:260-283) with
    alpha_t = lr(t) * sqrt(1-beta2^(t+1)) / (1-beta1^(t+1)), m/v starting at
    zero per predict call and updated only for trees inside the active
    range, evaluated chunk by chunk via masked exponent-shifted cumsums.
    """
    dev = Xn.device
    N = Xn.shape[0]
    T = ens.capacity
    with profiling.span("adam", rows=N, trees=T):
        O = cfg.output_dim
        C = _chunk_size(T, tree_chunk)
        f32 = dict(dtype=torch.float32, device=dev)
        # filled on the device: a tensor made from a host scalar is a copy
        # that waits for the card
        b1 = torch.full((), spec.beta_1, **f32)
        b2 = torch.full((), spec.beta_2, **f32)
        eps = torch.full((), spec.eps, **f32)

        t_all = torch.arange(T, dtype=torch.int32, device=dev)
        active_all = ((t_all >= start_tree) & (t_all < stop_tree)
                      & (t_all < ens.n_trees)).to(torch.float32)
        lr_all = scheduler_lr(spec, t_all)
        tf = t_all.to(torch.float32) + 1.0
        alpha_all = lr_all * torch.sqrt(1.0 - torch.pow(b2, tf)) / (
            1.0 - torch.pow(b1, tf))

        m_in = torch.zeros((N, O), **f32)
        v_in = torch.zeros((N, O), **f32)
        acc = torch.zeros((N, O), **f32)
        for t0 in range(0, T, C):
            sl = slice(t0, t0 + C)
            rel = chunk_leaf_rel(ens.feat[sl], ens.thr[sl], ens.cat_code[sl],
                                 ens.is_split[sl], ens.is_numeric[sl], Xn, Xc,
                                 cfg.max_depth)                   # [N, C]
            lv = ens.leaf_values[sl]
            g = lv[torch.arange(C, device=dev)[None, :], rel]      # [N, C, O]
            act = active_all[sl]
            a = act[None, :, None]
            cnt = torch.cumsum(act, dim=0)
            cj = cnt[None, :, None]
            # masked EMA in closed form:
            #   m_j = b^{cnt_j} (m_in + (1-b) sum_{i<=j} a_i b^{-cnt_i} g_i)
            inv1 = torch.pow(b1, -cnt)[None, :, None]
            inv2 = torch.pow(b2, -cnt)[None, :, None]
            B1 = torch.cumsum(a * inv1 * g, dim=1)
            B2 = torch.cumsum(a * inv2 * g * g, dim=1)
            m = torch.pow(b1, cj) * (m_in[:, None, :] + (1.0 - b1) * B1)
            v = torch.pow(b2, cj) * (v_in[:, None, :] + (1.0 - b2) * B2)
            upd = (a * alpha_all[sl][None, :, None] * m
                   / (torch.sqrt(v) + eps))
            acc = acc + torch.sum(upd, dim=1)
            m_in, v_in = m[:, -1, :], v[:, -1, :]
        return acc * _col_mask(spec, O, dev)[None, :]
