"""The program side of a PPO configuration on categorical observations:
the agent a training cell runs (agents/ppo.py's, on a string-valued env),
the spans its traced runs record, the work of each phase, and the readings
its check takes from the program.  The agent keeps each rollout's actions,
values and log-probabilities (a copy of three [T, E] arrays an iteration),
so that the check can replay the update after the one it reads."""
from __future__ import annotations

import numpy as np

from . import heap_arrays
from . import ppo
from .ppo import (SPANS, finite, iteration_steps,  # noqa: F401
                  span_context, trees_added, trees_per_iteration)
from ..work import ppo_categorical as work


def phase_work(cfg: dict, span: str, ctx: dict):
    """(operations, bytes) the algorithm needs for one span
    (work/ppo_categorical.py); the mirror's sync is a copy the algorithm
    does not need."""
    if span == "rollout":
        return work.rollout(cfg, ctx)
    if span == "update":
        return work.update(cfg, ctx)
    return 0, 0


def build(cfg: dict, device: str):
    """agents/ppo.py's agent, keeping each rollout's actions, values and
    log-probabilities in ``agent.rollouts``."""
    agent = ppo.build(cfg, device)
    agent.rollouts = []
    collect = agent.collect_rollout

    def collect_rollout(buffer, obs, dones, rng):
        out = collect(buffer, obs, dones, rng)
        agent.rollouts.append({f: getattr(buffer, f).reshape(-1).copy()
                               for f in ("actions", "values", "log_probs")})
        return out
    agent.collect_rollout = collect_rollout
    return agent


def checked_update(learner, cfg: dict):
    """The update the check reads: the first whose trees carry a leaf
    value other than 0 (before it every gradient is 0), the first update
    where none does; and whether one does."""
    n = int(learner.get_num_trees())
    lv = learner.ens.leaf_values[:n]
    nz = (lv != 0).flatten(1).any(dim=1).cpu().numpy()
    first = int(np.argmax(nz)) if nz.any() else 0
    return first // trees_per_iteration(cfg), bool(nz.any())


def _tree_arrays(lr, lo: int, hi: int) -> dict:
    return {f: getattr(lr.ens, f)[lo:hi].cpu().numpy()
            for f in ("feat", "cat_code", "is_split")}


def readings(agent, cfg: dict, X1: np.ndarray, k: int) -> dict:
    """What the check reads from a finished unit: its predictions over the
    checked update's rollout (string observations ``X1``) before and after
    each of that update's first k trees, through its own predict and
    vocabulary, and those trees' splits; its last rollout's codes, actions
    and forwards as its buffer holds them; the trees that served that
    rollout (every tree but the last iteration's).  Where an update
    follows the checked one (``next``): the splits of the checked update's
    trees and of the next one's first k, every tree up to those, and the
    next rollout's actions, values and log-probabilities."""
    model = agent.model
    lr = model.learner
    U = trees_per_iteration(cfg)
    r, signal = checked_update(lr, cfg)
    t0 = r * U
    bias = lr.get_bias().astype(np.float64)
    preds = []
    for t in range(t0, t0 + k + 1):
        if t == 0:
            preds.append(np.broadcast_to(bias, (len(X1), len(bias))))
            continue
        pol, val = model(X1, requires_grad=False, stop_idx=t)
        preds.append(np.concatenate([pol.cpu().numpy(),
                                     val.cpu().numpy()[:, None]], axis=1)
                     .astype(np.float64))
    arrs = _tree_arrays(lr, t0, t0 + k)
    b = agent._buffers[0]
    served = agent.curve[-2]["trees"] if len(agent.curve) > 1 else 0
    trees = heap_arrays(lr, served)
    trees["cat_code"] = lr.ens.cat_code[:served].cpu().numpy()
    nxt = None
    if signal and r + 1 < len(agent.rollouts):
        end = t0 + U + k
        follow = _tree_arrays(lr, t0, end)
        every = heap_arrays(lr, end)
        every["cat_code"] = lr.ens.cat_code[:end].cpu().numpy()
        ro = agent.rollouts[r + 1]
        nxt = dict(base=t0 + U, trees=every,
                   follow=[{f: a[t] for f, a in follow.items()}
                           for t in range(U + k)],
                   actions=ro["actions"],
                   values=ro["values"].astype(np.float64),
                   log_probs=ro["log_probs"].astype(np.float64))
    return dict(preds=np.stack(preds),
                first_trees=[{f: a[t] for f, a in arrs.items()}
                             for t in range(k)],
                rollout=dict(codes=b.flat_codes().copy(),
                             actions=b.actions.reshape(-1).copy(),
                             values=b.values.reshape(-1).astype(np.float64),
                             log_probs=b.log_probs.reshape(-1)
                             .astype(np.float64)),
                trees=trees, next=nxt)
