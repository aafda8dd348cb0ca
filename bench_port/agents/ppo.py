"""The program side of a PPO configuration: the agent a training cell runs,
the spans its traced runs record, the work of each phase, the readings its
check takes from the program, and the model a serving cell loads."""
from __future__ import annotations

import os

import numpy as np

from .. import envs
from . import heap_arrays, replace_arrays, split_arrays
from ..work import ppo as work

# (module, attribute, span) wrapped in traced runs, from outside the program
SPANS = (("gbrl_tpu_torch.rl.ppo", "PPO.collect_rollout", "rollout"),
         ("gbrl_tpu_torch.rl.ppo", "PPO.update", "update"),
         ("gbrl_tpu_torch.utils.host_mirror", "HostMirror.sync", "sync"))


def build(cfg: dict, device: str):
    """A fresh PPO agent on its own vector env."""
    from gbrl_tpu_torch.rl.ppo import PPO
    h = cfg["hyper"]
    return PPO(envs.make(cfg["env"], cfg["n_envs"]),
               tree_struct=dict(cfg["tree_struct"]),
               params=dict(cfg["params"]), policy_lr=h["policy_lr"],
               value_lr=h["value_lr"], n_steps=h["n_steps"],
               batch_size=h["batch_size"], n_epochs=h["n_epochs"],
               gamma=h["gamma"], gae_lambda=h["gae_lambda"],
               clip_range=h["clip_range"], ent_coef=h["ent_coef"],
               vf_coef=h["vf_coef"],
               normalize_advantage=h["normalize_advantage"], device=device)


def iteration_steps(cfg: dict) -> int:
    return cfg["hyper"]["n_steps"] * cfg["n_envs"]


def trees_per_iteration(cfg: dict) -> int:
    h = cfg["hyper"]
    n = iteration_steps(cfg)
    return h["n_epochs"] * -(-n // h["batch_size"])


def trees_added(cfg: dict) -> int:
    """Trees one update phase fits."""
    return trees_per_iteration(cfg)


def finite(agent) -> bool:
    """Whether the last rollout's values and log-probabilities are finite."""
    b = agent._buffers[0]
    return bool(np.isfinite(b.values).all() and np.isfinite(b.log_probs).all())


def span_context(agent) -> dict:
    """What the work of a span depends on, read as the span starts: the
    trees, from the host counter the RL loop keeps (reading the device's
    count would wait for the card)."""
    return dict(trees=int(agent.model.learner._rl_host_n_trees or 0))


def phase_work(cfg: dict, span: str, ctx: dict):
    """(operations, bytes) the algorithm needs for one span (work/ppo.py);
    the mirror's sync is a copy the algorithm does not need."""
    if span == "rollout":
        return work.rollout(cfg, ctx)
    if span == "update":
        return work.update(cfg, ctx)
    return 0, 0


def readings(agent, cfg: dict, X1: np.ndarray, k: int) -> dict:
    """What the check reads from a finished unit: its predictions over the
    first rollout's rows before and after each of its first k trees,
    through its own predict, and those trees' splits; its last rollout as
    its buffer holds it; the trees that served that rollout (every tree
    but the last iteration's)."""
    model = agent.model
    bias = model.learner.get_bias().astype(np.float64)
    preds = [np.broadcast_to(bias, (len(X1), len(bias)))]
    for t in range(1, k + 1):
        pol, val = model(X1, requires_grad=False, stop_idx=t)
        preds.append(np.concatenate([pol.cpu().numpy(),
                                     val.cpu().numpy()[:, None]], axis=1)
                     .astype(np.float64))
    b = agent._buffers[0]
    served = agent.curve[-2]["trees"] if len(agent.curve) > 1 else 0
    return dict(preds=np.stack(preds),
                first_trees=split_arrays(model.learner, k),
                rollout=dict(obs=b.obs.reshape(-1, b.obs.shape[-1]).copy(),
                             actions=b.actions.reshape(-1).copy(),
                             values=b.values.reshape(-1).astype(np.float64),
                             log_probs=b.log_probs.reshape(-1)
                             .astype(np.float64)),
                trees=heap_arrays(model.learner, served))


def serve_action(cfg: dict, out) -> np.ndarray:
    """A deployed client's actions: each env's most likely action (action
    0 where the request gave no finite answer)."""
    if out is None or not np.isfinite(out[0]).all():
        return np.zeros(cfg["n_envs"], np.int64)
    return np.argmax(out[0], axis=1)


def serving_model(cfg: dict, arrays: dict, directory: str, device: str):
    """Load the served ensemble through the port's checkpoint path: an
    ActorCritic of this configuration is saved, its ensemble arrays are
    replaced by ``arrays`` in the checkpoint, and the file is loaded back
    with ``ActorCritic.load_learner``.  Returns the request call: host
    observations in, (policy logits, values) on the host out."""
    from gbrl_tpu_torch.models.actor_critic import ActorCritic
    h = cfg["hyper"]
    A = cfg["n_actions"]
    model = ActorCritic(
        tree_struct=dict(cfg["tree_struct"]), input_dim=cfg["obs_dim"],
        output_dim=A + 1,
        policy_optimizer={"policy_algo": "SGD", "policy_lr": h["policy_lr"],
                          "start_idx": 0, "stop_idx": A},
        value_optimizer={"value_algo": "SGD", "value_lr": h["value_lr"],
                         "start_idx": A, "stop_idx": A + 1},
        shared_tree_struct=True, params=dict(cfg["params"]), device=device)
    path = os.path.join(directory, "served")
    model.save_learner(path)
    replace_arrays(path, arrays)
    served = ActorCritic.load_learner(path, device=device)

    def call(obs: np.ndarray):
        pol, val = served(obs, requires_grad=False)
        return pol.cpu().numpy(), val.cpu().numpy()
    return call

