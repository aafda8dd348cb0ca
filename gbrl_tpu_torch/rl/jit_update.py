"""The PPO update phase on the card: every epoch x minibatch of one update
runs as one loop over device tensors (counterpart of
``gbrl_tpu/rl/jit_update.py``).

The rollout is copied to the device once; then each minibatch runs predict
-> PPO-loss gradients -> candidates (K1; the categorical mask where the
rollout has codes) -> one tree (the level path or K6; the general path
with codes) -> an incremental prediction update, with no host
synchronisation inside the loop: the minibatch plan and the tree indices
are host integers, and every per-minibatch value stays a device tensor.
Where the JAX package has ``jax.jit`` and ``lax.fori_loop``, this is a
Python loop that queues its launches and returns.

``ppo_update_loop`` runs the minibatch body of ``_PPOGraphs`` once a
minibatch through ``rl/graphs.py`` ``run_step``: the body reads static
device buffers that the host refreshes once per update, a device counter
replaces the minibatch number and another the tree index, and each tree
leaves through [U] staging buffers that one ``write_tree`` of all U puts
into the ensemble after the loop.  On a CUDA device
each minibatch replays the body's captured CUDA graph; elsewhere the body
is called.  The sharded loop of ``parallel/sharded_rl.py`` runs
``ppo_minibatch_step`` instead.

Semantics are the torch facade path's (rl/ppo.py ``update``): clipped
surrogate + entropy bonus on the policy columns, 0.5 * vf_coef * MSE on the
value column, gradients scaled by the minibatch size as the facade's
``params.grad.detach() * n`` (models/actor_critic.py step; reference
gbt.py:174), candidates per minibatch as in Fitter::step_cpu (reference
fitter.cpp:50-115), per-sample gradient-norm clipping per block as
common.utils.clip_grad_norm (reference utils.py:270-295).
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from ..config import TreeConfig
from ..ensemble import Ensemble, ensure_capacity
from ..ops import fit
from ..ops.boosting import (_TREE_FIELDS, _masked_candidates, predict_sgd,
                            tree_prediction, write_tree)
from ..ops.candidates import bucketize, categorical_candidate_mask
from ..ops.fit import build_tree, standardize_l2
from ..optimizers import OptimizerSpec
from ..utils import profiling
from . import graphs
# GRAPH_CACHE stays importable from here: the benchmark's
# graph_minibatch_pct takes it as the mark of a program with graphs
from .graphs import GRAPH_CACHE, cached_graphs  # noqa: F401


class PPOHyper(NamedTuple):
    """PPO hyperparameters."""
    n_actions: int
    clip_range: float
    ent_coef: float
    vf_coef: float
    normalize_advantage: bool
    policy_clip: float   # 0.0 = off
    value_clip: float    # 0.0 = off


def _block_clip(g: torch.Tensor, max_norm: float) -> torch.Tensor:
    """Per-sample L2 clip of a gradient block (common.utils.clip_grad_norm)."""
    if not max_norm:
        return g
    norms = torch.sqrt(torch.sum(g * g, dim=-1, keepdim=True))
    return g * torch.clamp(max_norm / (norms + 1e-8), max=1.0)


def normalized_advantage(adv: torch.Tensor, w: torch.Tensor,
                         n_real: torch.Tensor) -> torch.Tensor:
    """(adv - mean) / (std + 1e-8) over the weighted rows, with torch's
    unbiased (n - 1) std."""
    m = torch.sum(adv * w) / n_real
    var = torch.sum(w * (adv - m) ** 2) / torch.clamp(n_real - 1.0, min=1.0)
    return (adv - m) / (torch.sqrt(var) + 1e-8)


def ppo_minibatch_grads(hp: PPOHyper, preds: torch.Tensor,
                        actions: torch.Tensor, old_logp: torch.Tensor,
                        adv: torch.Tensor, ret: torch.Tensor,
                        w: torch.Tensor) -> torch.Tensor:
    """Per-sample boosting gradients of the PPO objective with respect to
    the raw ensemble outputs [mb, na + 1] (policy logits | value), scaled by
    the real minibatch size (the facade's mean-loss gradient * n).  The
    gradient is ``torch.autograd.grad`` of the loss that ``jax.grad`` takes
    in the JAX package."""
    na = hp.n_actions
    n_real = torch.clamp(torch.sum(w), min=1.0)
    if hp.normalize_advantage:
        adv = normalized_advantage(adv, w, n_real)
    p = preds.detach().requires_grad_(True)
    with torch.enable_grad():
        logp_all = torch.log_softmax(p[:, :na], dim=-1)
        lp = torch.gather(logp_all, 1, actions.long()[:, None])[:, 0]
        ratio = torch.exp(lp - old_logp)
        pg1 = adv * ratio
        pg2 = adv * torch.clamp(ratio, 1.0 - hp.clip_range,
                                1.0 + hp.clip_range)
        policy_term = -torch.minimum(pg1, pg2)
        ent = -torch.sum(torch.exp(logp_all) * logp_all, dim=-1)
        value_term = hp.vf_coef * 0.5 * (ret - p[:, na]) ** 2
        per_sample = policy_term - hp.ent_coef * ent + value_term
        loss = torch.sum(per_sample * w) / n_real
        (g,) = torch.autograd.grad(loss, p)
    g = g * n_real * w[:, None]
    if hp.policy_clip or hp.value_clip:
        g = torch.cat([_block_clip(g[:, :na], hp.policy_clip),
                       _block_clip(g[:, na:], hp.value_clip)], dim=1)
    return g


def ppo_update_loop(cfg: TreeConfig, hp: PPOHyper, n_updates: int,
                    ens: Ensemble, X: torch.Tensor, mb_idx: torch.Tensor,
                    mb_n: Sequence[int], actions: torch.Tensor,
                    old_logp: torch.Tensor, adv: torch.Tensor,
                    ret: torch.Tensor, specs: Tuple[OptimizerSpec, ...],
                    feat_w: torch.Tensor, n_trees0: int,
                    valid: Optional[torch.Tensor] = None,
                    Xc: Optional[torch.Tensor] = None,
                    feat_w_cat: Optional[torch.Tensor] = None,
                    n_codes: int = 0) -> Tuple[Ensemble, torch.Tensor]:
    """Run ``n_updates`` PPO minibatch boosting steps on the tensors'
    device, with no host synchronisation.

    X [B, F] rollout observations (F may be 0); Xc [B, Fc] int32 their
    categorical codes or None, feat_w_cat [Fc] their weights and n_codes
    the code space (``GBTLearner._n_codes``); mb_idx [U, mb] int64 row
    indices into X
    (on the device; rows past mb_n[u] are padding and masked); mb_n [U]
    host ints; actions / old_logp / adv / ret / valid [B]; n_trees0 the
    ensemble's tree count (a host int, kept by the caller).  Predictions
    over the whole rollout are kept up to date incrementally: after each
    tree only that tree is evaluated on X (leaf values are immutable once
    fit), as ``ops.boosting.fit_loop`` does.  The ensemble must have room
    for ``n_updates`` more trees.  Returns (ensemble, [U] policy entropy of
    each minibatch, a diagnostic).  Each minibatch is one
    ``graphs.run_step`` of ``_PPOGraphs.body``."""
    if n_updates == 0:
        return ens, entropy_trace([], X.device)
    g = _ppo_graphs(cfg, hp, specs, n_updates, ens, X, mb_idx, feat_w,
                    valid is not None, Xc, n_codes)
    g.load(cfg, specs, ens, X, mb_idx, actions, old_logp, adv, ret, feat_w,
           n_trees0, valid, Xc, feat_w_cat)
    span = profiling.spanner()
    for u in range(n_updates):
        n_u = int(mb_n[u])
        with span("minibatch", u=u, learner="shared"):
            graphs.run_step(g.graphs, n_u, X.device,
                            lambda: g.body(cfg, hp, specs, n_u))
    idx = torch.arange(n_trees0, n_trees0 + n_updates, dtype=torch.int32,
                       device=X.device)
    return write_tree(ens, g.stage, idx), g.ent.clone()


def ppo_minibatch_step(cfg: TreeConfig, hp: PPOHyper,
                       specs: Tuple[OptimizerSpec, ...],
                       feat_w: torch.Tensor, ens: Ensemble,
                       t: Union[int, torch.Tensor], n_u: int,
                       w: torch.Tensor, Xmb: torch.Tensor, pmb: torch.Tensor,
                       act: torch.Tensor, old_logp: torch.Tensor,
                       adv: torch.Tensor, ret: torch.Tensor):
    """One minibatch of the sharded update phase
    (``parallel/sharded_rl.py``), its rows already gathered: PPO gradients
    from the predictions ``pmb`` -> candidates (K1) -> one tree written at
    index ``t`` (a host int or a device int32 scalar).  Returns (ensemble,
    tree, the tree index as a device tensor, the minibatch's mean policy
    entropy)."""
    tree, t_idx, ent = ppo_minibatch_tree(cfg, hp, specs, feat_w, t, n_u, w,
                                          Xmb, pmb, act, old_logp, adv, ret)
    with profiling.span("write"):
        ens = write_tree(ens, tree, t_idx)
    return ens, tree, t_idx, ent


def ppo_minibatch_tree(cfg: TreeConfig, hp: PPOHyper,
                       specs: Tuple[OptimizerSpec, ...],
                       feat_w: torch.Tensor, t: Union[int, torch.Tensor],
                       n_u: int, w: torch.Tensor, Xmb: torch.Tensor,
                       pmb: torch.Tensor, act: torch.Tensor,
                       old_logp: torch.Tensor, adv: torch.Tensor,
                       ret: torch.Tensor, Xc: Optional[torch.Tensor] = None,
                       feat_w_cat: Optional[torch.Tensor] = None,
                       n_codes: int = 0):
    """``ppo_minibatch_step`` up to its tree, which it does not write:
    (tree, the tree index as a device tensor, the mean policy entropy).
    With codes ``Xc`` the categorical candidates are every (feature, code)
    pair of the weighted rows, ranked by the rows' squared gradient norms
    as ``ops.boosting.boost_step`` ranks them."""
    span = profiling.span
    with span("grads"):
        grads = ppo_minibatch_grads(hp, pmb, act, old_logp, adv, ret, w)
        build = standardize_l2(grads, w) if cfg.score == "l2" else grads
    cand_vals = Xb = cat_valid = None
    with span("candidates"):
        if Xmb.shape[1] > 0:
            cand_vals = _masked_candidates(cfg, Xmb, n_u)
            Xb = bucketize(Xmb, cand_vals)
        if Xc is not None:
            cat_valid = categorical_candidate_mask(
                Xc, torch.sum(grads * grads, dim=-1), cfg.n_bins, n_codes, w)
    tree = build_tree(cfg, Xb, cand_vals, grads, build, w, feat_w, Xc,
                      cat_valid, feat_w_cat)
    t_idx = (t if isinstance(t, torch.Tensor) else
             torch.full((), t, dtype=torch.int32, device=Xmb.device))
    # mean policy entropy of this minibatch (diagnostic)
    logp_all = torch.log_softmax(pmb[:, :hp.n_actions], dim=-1)
    ent = -torch.sum(torch.exp(logp_all) * logp_all, dim=-1)
    return tree, t_idx, torch.sum(ent * w) / torch.clamp(torch.sum(w),
                                                         min=1.0)


class _PPOGraphs:
    """The static device buffers of one update's shapes and, on a CUDA
    device, the CUDA graphs of its minibatch body, one per real row count
    ``n_u`` (a partial last minibatch has its own).  The body reads the
    rollout (its codes too, where it has them), the plan and the
    predictions from the buffers, gathers its rows with the device counter
    ``u``, fits tree ``t``, stages the tree and the entropy at row ``u``,
    adds the tree to the predictions and counts ``u`` and ``t`` on."""

    def __init__(self, ens: Ensemble, X: torch.Tensor, mb_idx: torch.Tensor,
                 feat_w: torch.Tensor, U: int, valid: bool,
                 Xc: Optional[torch.Tensor], n_codes: int):
        dev = X.device
        B = X.shape[0]

        def empty(shape, dtype):
            return torch.empty(shape, dtype=dtype, device=dev)
        self.X = empty(tuple(X.shape), X.dtype)
        self.plan = empty(tuple(mb_idx.shape), torch.int64)
        self.act = empty((B,), torch.int64)
        self.old_logp, self.adv, self.ret = (
            empty((B,), torch.float32) for _ in range(3))
        self.valid = empty((B,), torch.float32) if valid else None
        self.feat_w = empty(tuple(feat_w.shape), feat_w.dtype)
        self.Xc = None if Xc is None else empty(tuple(Xc.shape), torch.int32)
        self.feat_w_cat = (None if Xc is None else
                           empty((Xc.shape[1],), torch.float32))
        self.n_codes = n_codes
        self.preds = empty((B, ens.output_dim), torch.float32)
        self.u = torch.zeros((1,), dtype=torch.int64, device=dev)
        self.t = torch.zeros((), dtype=torch.int32, device=dev)
        self.stage = {f: empty((U,) + tuple(getattr(ens, f).shape[1:]),
                               getattr(ens, f).dtype) for f in _TREE_FIELDS}
        self.stage["depth"] = empty((U,), torch.int32)
        self.ent = empty((U,), torch.float32)
        self.graphs = {}

    def load(self, cfg: TreeConfig, specs: Tuple[OptimizerSpec, ...],
             ens: Ensemble, X: torch.Tensor, mb_idx: torch.Tensor,
             actions: torch.Tensor, old_logp: torch.Tensor,
             adv: torch.Tensor, ret: torch.Tensor, feat_w: torch.Tensor,
             n_trees0: int, valid: Optional[torch.Tensor],
             Xc: Optional[torch.Tensor],
             feat_w_cat: Optional[torch.Tensor]) -> None:
        """Refresh the static inputs (once per update): the rollout, the
        plan, the predictions of the ensemble's trees, the counters."""
        for buf, src in ((self.X, X), (self.plan, mb_idx),
                         (self.act, actions), (self.old_logp, old_logp),
                         (self.adv, adv), (self.ret, ret),
                         (self.feat_w, feat_w), (self.valid, valid),
                         (self.Xc, Xc), (self.feat_w_cat, feat_w_cat)):
            if buf is not None:
                buf.copy_(src)
        self.preds.copy_(predict_sgd(cfg, ens, X, specs, 0, n_trees0, Xc))
        self.u.zero_()
        self.t.fill_(n_trees0)

    def body(self, cfg: TreeConfig, hp: PPOHyper,
             specs: Tuple[OptimizerSpec, ...], n_u: int) -> None:
        idx = torch.index_select(self.plan, 0, self.u)[0]
        w = (torch.arange(idx.shape[0], device=idx.device)
             < n_u).to(torch.float32)
        if self.valid is not None:
            w = w * self.valid[idx]     # autoreset rows (rl/buffers.py flat)
        tree, t_idx, ent = ppo_minibatch_tree(
            cfg, hp, specs, self.feat_w, self.t, n_u, w, self.X[idx],
            self.preds[idx], self.act[idx], self.old_logp[idx],
            self.adv[idx], self.ret[idx],
            None if self.Xc is None else self.Xc[idx], self.feat_w_cat,
            self.n_codes)
        with profiling.span("write"):
            for f, buf in self.stage.items():
                buf.index_copy_(0, self.u, tree[f].reshape(
                    (1,) + buf.shape[1:]).to(buf.dtype))
            self.ent.index_copy_(0, self.u, ent.reshape(1))
        with profiling.span("predict_new"):
            self.preds.add_(tree_prediction(cfg, specs, tree, t_idx, self.X,
                                            self.Xc))
        self.u.add_(1)
        self.t.add_(1)


def _ppo_graphs(cfg: TreeConfig, hp: PPOHyper,
                specs: Tuple[OptimizerSpec, ...], U: int, ens: Ensemble,
                X: torch.Tensor, mb_idx: torch.Tensor, feat_w: torch.Tensor,
                valid: bool, Xc: Optional[torch.Tensor] = None,
                n_codes: int = 0) -> _PPOGraphs:
    # the code space is baked into a capture: a vocabulary that crosses a
    # power of two gets a graph set of its own
    key = (X.device, cfg, hp, specs, U, tuple(X.shape), X.dtype,
           tuple(mb_idx.shape), tuple(feat_w.shape), feat_w.dtype, valid,
           None if Xc is None else Xc.shape[1], n_codes,
           fit._DISABLE_FUSED_TREE)
    return cached_graphs(key, lambda: _PPOGraphs(ens, X, mb_idx, feat_w, U,
                                                 valid, Xc, n_codes))


def entropy_trace(ents: list, dev: torch.device) -> torch.Tensor:
    """[U] per-minibatch entropies (empty when no minibatch ran)."""
    return (torch.stack(ents) if ents else
            torch.zeros((0,), dtype=torch.float32, device=dev))


def minibatch_plan(n: int, n_epochs: int, batch_size: int, rng):
    """The epoch/minibatch index plan of one update phase: (mb_idx [U, bs]
    int64, mb_n [U]), one permutation of the rollout per epoch, minibatches
    of fewer than 2 rows dropped as the facade path drops them."""
    bs = min(batch_size, n)
    per_epoch = (n + bs - 1) // bs
    U = n_epochs * per_epoch
    mb_idx = np.zeros((U, bs), dtype=np.int64)
    mb_n = np.zeros((U,), dtype=np.int64)
    u = 0
    for _ in range(n_epochs):
        perm = rng.permutation(n)
        for start in range(0, n, bs):
            sl = perm[start:start + bs]
            mb_idx[u, :len(sl)] = sl
            mb_n[u] = len(sl)
            u += 1
    keep = mb_n >= 2
    return mb_idx[keep], mb_n[keep]


def _numeric_block(obs: np.ndarray, dev: torch.device) -> torch.Tensor:
    """The rollout's numeric block [B, Fn] on ``dev``: a copy that waits
    for the card (``sync.prepare``) where it has columns, none where it
    has none."""
    x = np.ascontiguousarray(obs, np.float32).reshape(len(obs), -1)
    if x.shape[1] == 0:
        return torch.zeros(x.shape, dtype=torch.float32, device=dev)
    profiling.count_sync("prepare", dev.type == "cuda")
    return torch.from_numpy(x).to(dev)


def run_ppo_update(learner, obs: np.ndarray, actions: np.ndarray,
                   old_log_probs: np.ndarray, advantages: np.ndarray,
                   returns: np.ndarray, hp: PPOHyper, n_epochs: int,
                   batch_size: int, rng,
                   valid: Optional[np.ndarray] = None,
                   codes: Optional[np.ndarray] = None) -> np.ndarray:
    """Host wrapper: build the minibatch plan, copy the rollout to the
    device once (observations, one packed [B, 5] float block and the plan),
    run the loop, read the entropy trace back.  A learner with categorical
    features takes ``obs`` as the numeric block and ``codes`` [B, Fc]
    int32 as the categorical one (``PPO._features``), copied once more
    (``sync.ppo_codes``).  Updates the learner in
    place; returns the trace.  Spans (utils/profiling.py): ``update``
    holds ``update.stage`` (everything before the loop), a ``minibatch``
    a tree and ``update.readback``."""
    with profiling.span("update", algo="ppo"):
        with profiling.span("update.stage"):
            mb_idx, mb_n = minibatch_plan(len(obs), n_epochs, batch_size,
                                          rng)
            U = len(mb_n)
            dev = learner.torch_device
            on_card = dev.type == "cuda"
            if codes is None:
                Xn, Xc = learner._prepare(obs, grow_vocab=False)
                assert Xc is None, \
                    "a learner with categorical features takes the codes"
            else:
                Xn = _numeric_block(obs, dev)
                Xc = torch.from_numpy(
                    np.ascontiguousarray(codes, np.int32)).to(dev)
                profiling.count_sync("ppo_codes", on_card)
            # the host copy of n_trees: reading ens.n_trees would wait for
            # the card
            nt = learner._rl_host_n_trees
            if nt is None:
                nt = learner.get_num_trees()
            learner.ens = ensure_capacity(learner.ens, nt + U)
            learner._rl_host_n_trees = nt + U
            n = len(obs)
            cols = [np.asarray(actions, np.float32).reshape(n),
                    np.asarray(old_log_probs, np.float32).reshape(n),
                    np.asarray(advantages, np.float32).reshape(n),
                    np.asarray(returns, np.float32).reshape(n),
                    (np.ones(n, np.float32) if valid is None
                     else np.asarray(valid, np.float32).reshape(n))]
            pack = torch.from_numpy(np.stack(cols, axis=1)).to(dev)
            profiling.count_sync("ppo_pack", on_card)
            plan = torch.from_numpy(mb_idx).to(dev)
            profiling.count_sync("ppo_plan", on_card)
            feat_w = learner._internal_feature_weights()
            n_num = Xn.shape[1]
        learner.ens, ent_trace = ppo_update_loop(
            learner.cfg, hp, U, learner.ens, Xn, plan, mb_n.tolist(),
            pack[:, 0].to(torch.int64), pack[:, 1], pack[:, 2], pack[:, 3],
            learner.specs, feat_w[:n_num], nt,
            None if valid is None else pack[:, 4], Xc,
            None if Xc is None else feat_w[n_num:], learner._n_codes())
        learner.total_iterations += U
        learner._pred_cache = None
        with profiling.span("update.readback"):
            profiling.count_sync("ppo_readback", on_card)
            return ent_trace.cpu().numpy()
