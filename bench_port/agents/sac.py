"""The program side of a SAC configuration: the agent a training cell runs,
the spans its traced runs record, the work of each phase and the readings
its check takes from the program."""
from __future__ import annotations

import numpy as np

from .. import envs
from ..work import sac as work
from . import heap_arrays, split_arrays

# (module, attribute, span) wrapped in traced runs, from outside the program
SPANS = (("gbrl_tpu_torch.rl.sac", "SAC._rollout", "rollout"),
         ("gbrl_tpu_torch.rl.sac", "SAC._train", "update"),
         ("gbrl_tpu_torch.rl.sac", "SAC._sync_mirror", "sync"))

ROLES = ("critic0", "critic1", "actor")


def build(cfg: dict, device: str):
    """A fresh SAC agent on its own vector env, on the fused step.  A
    program whose SAC keeps no curve and has no train-event methods to
    wrap cannot run the cell: the run ends at set-up."""
    from gbrl_tpu_torch.rl.sac import SAC

    from ..harness import BenchError
    missing = [m for _, m, _ in SPANS if not hasattr(SAC, m.split(".")[1])]
    if missing:
        raise BenchError(f"this program's SAC has no {', '.join(missing)}")
    h = cfg["hyper"]
    return SAC(envs.make(cfg["env"], cfg["n_envs"]),
               tree_struct=dict(cfg["tree_struct"]),
               params=dict(cfg["params"]), actor_lr=h["actor_lr"],
               critic_lr=h["critic_lr"], bias_lr=h["bias_lr"],
               schedule_T=h["schedule_T"], q_func_type=h["q_func_type"],
               n_critics=h["n_critics"], buffer_size=h["buffer_size"],
               batch_size=h["batch_size"], gamma=h["gamma"],
               n_step=h["n_step"], learning_starts=h["learning_starts"],
               train_freq=h["train_freq"],
               gradient_steps=h["gradient_steps"],
               target_update_interval=h["target_update_interval"],
               ent_coef=h["ent_coef"], target_entropy=h["target_entropy"],
               log_std_init=h["log_std_init"],
               max_grad_norm=h["max_grad_norm"], device=device)


def iteration_steps(cfg: dict) -> int:
    """Env steps the training mix's warm-up counts as an iteration: twice
    this (1,040 steps) passes ``learning_starts`` (1,000) and takes three
    train events (six fused steps and three mirror syncs), so the host
    mirror's library is built and loaded, and every kernel, host path and
    device shape of a train event has run once, before the window opens.
    The fused step captures no CUDA graph and its kernels are built once
    for every size: a longer warm-up runs nothing new."""
    h = cfg["hyper"]
    event = cfg["n_envs"] * h["train_freq"]
    first = -(-h["learning_starts"] // event) * event
    return -(-(first + 2 * event) // 2)


def trees_added(cfg: dict) -> int:
    """Trees one train event fits: one per learner and gradient step."""
    h = cfg["hyper"]
    return h["gradient_steps"] * (1 + h["n_critics"])


def finite(agent) -> bool:
    """Whether the last rollout's actions are finite."""
    return bool(np.isfinite(agent._last_rollout[1]).all())


def span_context(agent) -> dict:
    """What the work of a span depends on, read as the span starts: the
    trees each learner holds (the host counters the loop keeps), the
    critics' target prefixes and the env steps so far."""
    return dict(actor_trees=int(agent.actor.learner._rl_host_n_trees or 0),
                critic_trees=int(agent.critics[0].learner._rl_host_n_trees
                                 or 0),
                prefixes=[int(c.target_prefix) for c in agent.critics],
                steps=int(agent._steps))


def phase_work(cfg: dict, span: str, ctx: dict):
    """(operations, bytes) the algorithm needs for one span (work/sac.py)."""
    if span == "rollout":
        return work.rollout(cfg, ctx)
    if span == "update":
        return work.update(cfg, ctx)
    return 0, 0


def _learners(agent) -> dict:
    return dict(zip(ROLES, [c.learner for c in agent.critics]
                    + [agent.actor.learner]))


def readings(agent, cfg: dict, X1: np.ndarray, k: int) -> dict:
    """What the check reads from a finished unit: each learner's
    predictions over the checked rows before and after each of its first
    k trees, through the learner's own predict, and those trees' splits;
    the last rollout's observations and the actions the mirror's outputs
    gave, with the actor trees that served it; then the targets of one
    more fused step (``target_step``)."""
    out = {}
    lrs = _learners(agent)
    for role, lr in lrs.items():
        bias = lr.get_bias().astype(np.float64)
        preds = [np.broadcast_to(bias, (len(X1), len(bias)))]
        for t in range(1, k + 1):
            p = lr.predict(X1, requires_grad=False, stop_idx=t)
            preds.append(p.cpu().numpy().reshape(len(X1), -1)
                         .astype(np.float64))
        out[role] = np.stack(preds)
    out["first_trees"] = {role: split_arrays(lr, k)
                          for role, lr in lrs.items()}
    O, A = agent._last_rollout
    served = agent.curve[-2]["trees"] if len(agent.curve) > 1 else 0
    out["rollout"] = dict(obs=O.reshape(-1, O.shape[-1]).copy(),
                          actions=A.reshape(-1, A.shape[-1])
                          .astype(np.float64),
                          steps=int(agent._steps))
    out["trees"] = heap_arrays(agent.actor.learner, served)
    out["target"] = target_step(agent)
    return out


def target_step(agent) -> dict:
    """One more fused step of the finished unit, through the program's own
    path (``SAC.train_step``: a replay batch, the packed prefixes, the
    step), keeping each critic's target sums as the step computes them:
    the first ensemble sum of each critic's ensemble in ``sac_train_step``
    (rl/jit_sac.py), over the next observations up to the critic's
    ``target_prefix``.  Returns those sums, the next observations and each
    critic's trees as they stood, so that the check walks the right prefix
    of the right critic over the same rows.  At the cell's size the
    critics hold a few hundred trees and the prefix has moved past 0."""
    from gbrl_tpu_torch.rl import jit_sac
    held = [heap_arrays(c.learner, c.learner._rl_host_n_trees)
            for c in agent.critics]
    step, walk = jit_sac.sac_train_step, jit_sac.predict_sgd
    ens, calls = [], []

    def step_kept(*args):
        ens.extend(args[5])                 # the critics' ensembles
        return step(*args)

    def walk_kept(cfg, e, X, *args):
        y = walk(cfg, e, X, *args)
        calls.append((e, X.detach().cpu().numpy(),
                      y.detach().cpu().numpy().astype(np.float64)))
        return y
    jit_sac.sac_train_step, jit_sac.predict_sgd = step_kept, walk_kept
    try:
        agent.train_step(agent._train_gen, np.random.default_rng(0))
    finally:
        jit_sac.sac_train_step, jit_sac.predict_sgd = step, walk
    first = [next(c for c in calls if c[0] is e) for e in ens]
    return dict(obs=first[0][1], sums=[y for _, _, y in first], trees=held)
