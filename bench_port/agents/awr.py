"""The program side of an AWR configuration: the agent a training cell runs,
the spans its traced runs record, the work of each phase, the readings its
check takes from the program, and the model a serving cell loads."""
from __future__ import annotations

import os

import numpy as np

from .. import envs
from ..work import awr as work
from . import heap_arrays, replace_arrays, split_arrays

# (module, attribute, span) wrapped in traced runs, from outside the program
SPANS = (("gbrl_tpu_torch.rl.awr", "AWR._rollout", "rollout"),
         ("gbrl_tpu_torch.rl.awr", "AWR._recompute_replay", "replay"),
         ("gbrl_tpu_torch.rl.jit_awr", "run_awr_update", "update"),
         ("gbrl_tpu_torch.rl.awr", "AWR._sync_mirrors", "sync"))


def build(cfg: dict, device: str):
    """A fresh AWR agent on its own vector env."""
    from gbrl_tpu_torch.rl.awr import AWR
    h = cfg["hyper"]
    return AWR(envs.make(cfg["env"], cfg["n_envs"]),
               tree_struct=dict(cfg["tree_struct"]),
               params=dict(cfg["params"]),
               feature_weights=np.asarray(cfg["feature_weights"], np.float32),
               actor_lr=h["actor_lr"], critic_lr=h["critic_lr"],
               beta=h["beta"], max_weight=h["max_weight"],
               n_steps=h["n_steps"], gamma=h["gamma"],
               gae_lambda=h["gae_lambda"], actor_updates=h["actor_updates"],
               critic_updates=h["critic_updates"],
               batch_size=h["batch_size"], buffer_size=h["buffer_size"],
               log_std_init=h["log_std_init"], learn_std=h["learn_std"],
               log_std_final=h["log_std_final"],
               max_actor_grad_norm=h["max_actor_grad_norm"], device=device)


def iteration_steps(cfg: dict) -> int:
    return cfg["hyper"]["n_steps"]


def trees_added(cfg: dict) -> int:
    """Trees one update phase fits: the critic's and the actor's."""
    h = cfg["hyper"]
    return h["critic_updates"] + h["actor_updates"]


def finite(agent) -> bool:
    """Whether the last rollout's actions are finite."""
    return bool(np.isfinite(agent._replay[-1][2]).all())


def span_context(agent) -> dict:
    """What the work of a span depends on, read as the span starts."""
    rows = [int(c[6].sum()) for c in agent._replay]
    return dict(actor_trees=int(agent.actor.learner._rl_host_n_trees or 0),
                critic_trees=int(agent.critic.learner._rl_host_n_trees or 0),
                replay_rows=sum(rows))


def phase_work(cfg: dict, span: str, ctx: dict):
    """(operations, bytes) the algorithm needs for one span (work/awr.py):
    the replay's values are the critic's new trees over every row, or all
    of its trees over rows it has not valued yet (the newest chunk)."""
    if span == "rollout":
        return work.rollout(cfg, ctx)
    if span == "update":
        return work.update(cfg, ctx)
    if span == "replay":
        Kc = cfg["hyper"]["critic_updates"]
        newest = cfg["hyper"]["n_steps"]
        old = max(ctx["replay_rows"] - newest, 0)
        o1, b1 = work.replay(cfg, dict(replay_rows=old,
                                       critic_new_trees=min(
                                           Kc, ctx["critic_trees"])))
        o2, b2 = work.replay(cfg, dict(replay_rows=min(newest,
                                                       ctx["replay_rows"]),
                                       critic_new_trees=ctx["critic_trees"]))
        return o1 + o2, b1 + b2
    return 0, 0


def readings(agent, cfg: dict, X1: np.ndarray, k: int) -> dict:
    """What the check reads from a finished unit: the critic's and the
    actor's predictions over the first replay's rows before and after each
    of their first k trees, through the models' own calls, and those
    trees' splits; the last
    rollout as the replay holds it, with every rollout's actions (the
    reference replays the draws that led to it) and the actor trees that
    served it; the replay's values as the last recompute left them (the
    critic's trees added incrementally to each chunk's cache) with the
    critic trees and bias they stand for."""
    out = {}
    for role, model in (("critic", agent.critic), ("actor", agent.actor)):
        bias = model.learner.get_bias().astype(np.float64)
        preds = [np.broadcast_to(bias, (len(X1), 1))]
        for t in range(1, k + 1):
            p = model(X1, requires_grad=False, stop_idx=t)
            p = p[0] if isinstance(p, tuple) else p
            preds.append(p.cpu().numpy().reshape(len(X1), 1)
                         .astype(np.float64))
        out[role] = np.stack(preds)
    out["first_trees"] = {role: split_arrays(model.learner, k)
                          for role, model in (("critic", agent.critic),
                                              ("actor", agent.actor))}
    O, _, A = agent._replay[-1][:3]
    served = agent.curve[-2]["trees"] if len(agent.curve) > 1 else 0
    out["rollout"] = dict(obs=O.reshape(-1, O.shape[-1]).copy(),
                          actions=A.reshape(-1, A.shape[-1])
                          .astype(np.float64),
                          chunk_actions=[c[2].copy() for c in agent._replay])
    out["trees"] = heap_arrays(agent.actor.learner, served)
    caches = agent._vcache
    t = caches[0]["t"]
    assert all(c["t"] == t for c in caches), "the replay's caches disagree"
    obs, vals = [], []
    for (O, NO, *_), c in zip(agent._replay, caches):
        obs += [O.reshape(-1, O.shape[-1]), NO.reshape(-1, NO.shape[-1])]
        vals += [c["v"], c["vn"]]
    critic = heap_arrays(agent.critic.learner, t)
    critic["bias"] = caches[0]["bias"].astype(np.float64)
    out["replay"] = dict(obs=np.concatenate(obs),
                         values=np.concatenate(vals).astype(np.float64),
                         trees=critic)
    return out


def serve_action(cfg: dict, out) -> np.ndarray:
    """A deployed client's actions: each env's mean action, clipped to the
    action range (no torque where the request gave no finite answer)."""
    shape = (cfg["n_envs"], cfg["act_dim"])
    if out is None or not np.isfinite(out[0]).all():
        return np.zeros(shape, np.float32)
    m = cfg["max_action"]
    return np.clip(out[0], -m, m).reshape(shape)


def serving_model(cfg: dict, arrays: dict, directory: str, device: str):
    """Load the served ensemble through the port's checkpoint path: a
    GaussianActor of this configuration is saved, its ensemble arrays are
    replaced by ``arrays`` in the checkpoint, and its learner is loaded
    back with ``GBTLearner.load`` (GaussianActor has no loader of its own).
    Returns the request call: host observations in, (mean action, log
    sigma) on the host out."""
    from gbrl_tpu_torch.learners.gbt_learner import GBTLearner
    from gbrl_tpu_torch.models.actor import GaussianActor
    h = cfg["hyper"]
    A = cfg["act_dim"]
    actor = GaussianActor(
        tree_struct=dict(cfg["tree_struct"]), input_dim=cfg["obs_dim"],
        output_dim=A, mu_optimizer={"mu_algo": "SGD", "mu_lr": h["actor_lr"],
                                    "start_idx": 0, "stop_idx": A},
        log_std_init=h["log_std_init"], params=dict(cfg["params"]),
        device=device)
    path = os.path.join(directory, "served")
    actor.save_learner(path)
    replace_arrays(path, arrays)
    actor.learner = GBTLearner.load(path, device=device)

    def call(obs: np.ndarray):
        mu, log_std = actor(obs, requires_grad=False)
        return mu.cpu().numpy(), log_std.cpu().numpy()
    return call
