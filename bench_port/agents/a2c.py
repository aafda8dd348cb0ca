"""The program side of an A2C configuration: the agent a training cell runs
(``gbrl_tpu_torch.rl.A2C`` with its fused update on the card and its
rollouts served by the host mirror), the spans its traced runs record, the
work of each phase, and the readings its check takes from the program.
The agent keeps the observations and actions of its first ``KEPT``
rollouts (a copy of two small arrays, the first three iterations of a
unit only), so that the check can replay the trees fit on them."""
from __future__ import annotations

import numpy as np

from .. import envs
from . import heap_arrays, split_arrays
from ..work import a2c as work

# (module, attribute, span) wrapped in traced runs, from outside the program
SPANS = (("gbrl_tpu_torch.rl.a2c", "A2C.collect_rollout", "rollout"),
         ("gbrl_tpu_torch.rl.a2c", "A2C.update", "update"))
# rollouts whose observations and actions a unit keeps for the check
KEPT = 3


def build(cfg: dict, device: str):
    """A fresh A2C agent on its own vector env, keeping its first ``KEPT``
    rollouts' observations and actions in ``agent.rollouts``."""
    from gbrl_tpu_torch.rl.a2c import A2C
    h = cfg["hyper"]
    agent = A2C(envs.make(cfg["env"], cfg["n_envs"]),
                tree_struct=dict(cfg["tree_struct"]),
                params=dict(cfg["params"]), policy_lr=h["policy_lr"],
                value_lr=h["value_lr"], policy_algo=h["policy_algo"],
                n_steps=h["n_steps"], gamma=h["gamma"],
                gae_lambda=h["gae_lambda"], ent_coef=h["ent_coef"],
                vf_coef=h["vf_coef"],
                control_variates=h["control_variates"],
                normalize_advantage=h["normalize_advantage"], device=device,
                jit_update=True)
    agent.rollouts = []
    collect = agent.collect_rollout

    def collect_rollout(buffer, obs, dones, rng):
        out = collect(buffer, obs, dones, rng)
        if len(agent.rollouts) < KEPT:
            agent.rollouts.append(dict(
                obs=buffer.obs.reshape(-1, buffer.obs.shape[-1]).copy(),
                actions=buffer.actions.reshape(-1).copy()))
        return out
    agent.collect_rollout = collect_rollout
    return agent


def iteration_steps(cfg: dict) -> int:
    return cfg["hyper"]["n_steps"] * cfg["n_envs"]


def trees_added(cfg: dict) -> int:
    """Trees one update fits."""
    return 1


def finite(agent) -> bool:
    """Whether the last rollout's values and log-probabilities are finite."""
    b = agent._buffer
    return bool(np.isfinite(b.values).all() and np.isfinite(b.log_probs).all())


def span_context(agent) -> dict:
    """What the work of a span depends on, read as the span starts: the
    trees, from the host counter the RL loop keeps (reading the device's
    count would wait for the card)."""
    return dict(trees=int(agent.model.learner._rl_host_n_trees or 0))


def phase_work(cfg: dict, span: str, ctx: dict):
    """(operations, bytes) the algorithm needs for one span
    (work/a2c.py)."""
    if span == "rollout":
        return work.rollout(cfg, ctx)
    if span == "update":
        return work.update(cfg, ctx)
    return 0, 0


def readings(agent, cfg: dict, X1: np.ndarray, k: int) -> dict:
    """What the check reads from a finished unit: its predictions over the
    first rollout's rows before and after each of its first k trees, and
    over each of the first k rollouts' rows before its tree, through its
    own predict (Adam on the policy columns), those trees' splits and
    those rollouts' actions; its last rollout as its buffer holds it; the
    trees that served that rollout (every tree but the last)."""
    assert k <= len(agent.rollouts), "the unit kept fewer rollouts than k"
    model = agent.model
    bias = model.learner.get_bias().astype(np.float64)

    def predict(X, t):
        if t == 0:
            return np.broadcast_to(bias, (len(X), len(bias)))
        pol, val = model(X, requires_grad=False, stop_idx=t)
        return np.concatenate([pol.cpu().numpy(), val.cpu().numpy()[:, None]],
                              axis=1).astype(np.float64)
    b = agent._buffer
    served = agent.curve[-2]["trees"] if len(agent.curve) > 1 else 0
    kept = agent.rollouts[:k]
    return dict(preds=np.stack([predict(X1, t) for t in range(k + 1)]),
                pre=np.stack([predict(r["obs"], u)
                              for u, r in enumerate(kept)]),
                actions=[r["actions"] for r in kept],
                first_trees=split_arrays(model.learner, k),
                rollout=dict(obs=b.obs.reshape(-1, b.obs.shape[-1]).copy(),
                             actions=b.actions.reshape(-1).copy(),
                             values=b.values.reshape(-1).astype(np.float64),
                             log_probs=b.log_probs.reshape(-1)
                             .astype(np.float64)),
                trees=heap_arrays(model.learner, served))
