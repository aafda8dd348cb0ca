"""Operations and bytes of an AWR iteration with a Gaussian tree actor and
a tree critic: the rollout's forwards, the replay's values, the update."""
from __future__ import annotations

from . import trees

# per row: the critic's squared error and gradient; the actor's
# standardised advantage, weight, weighted error, gradient and clip
CRITIC_OPS_PER_ROW = 4
ACTOR_OPS_PER_ROW = 16
# per replay row: the TD error and the GAE recursion
TD_OPS_PER_ROW = 8


def _shape(cfg: dict):
    ts = cfg["tree_struct"]
    return (cfg["obs_dim"], ts["n_bins"], cfg["act_dim"], ts["max_depth"],
            ts["grow_policy"] == "oblivious")


def rollout(cfg: dict, ctx: dict):
    """Every env step's actor forward (``ctx["actor_trees"]``) for each
    env, the action drawn around it."""
    F, _, A, D, _ = _shape(cfg)
    E = cfg["n_envs"]
    steps = cfg["hyper"]["n_steps"] // E
    ops, byt = trees.walk(E, F, ctx["actor_trees"], D, A)
    ops = steps * (ops + E * 3 * A)
    byt = byt + (steps - 1) * E * (F + A) * trees.F32
    return ops, byt


def replay(cfg: dict, ctx: dict):
    """The replay's values recomputed with the critic: the trees added
    since the last recompute over every observation and next observation
    (``ctx["replay_rows"]``, ``ctx["critic_new_trees"]``), then TD(lambda)."""
    F, _, _, D, _ = _shape(cfg)
    R = ctx["replay_rows"]
    ops, byt = trees.walk(2 * R, F, ctx["critic_new_trees"], D, 1)
    return ops + R * TD_OPS_PER_ROW, byt


def update(cfg: dict, ctx: dict):
    """One update: each critic step predicts its minibatch over the
    critic's trees so far and fits one tree; then each actor step likewise
    with the actor's trees."""
    F, B, A, D, obl = _shape(cfg)
    h = cfg["hyper"]
    R = ctx["replay_rows"]
    mb = min(h["batch_size"], R)
    ops = 0
    byt = R * (F + A + 2) * trees.F32
    for k, before, per_row, O in (
            (h["critic_updates"], ctx["critic_trees"], CRITIC_OPS_PER_ROW, 1),
            (h["actor_updates"], ctx["actor_trees"], ACTOR_OPS_PER_ROW, A)):
        byt += k * mb * 8
        for u in range(k):
            o, b = trees.walk(mb, F, before + u, D, O)
            ops += o
            byt += b - mb * (F + O) * trees.F32      # rows counted above
            o, b = trees.fit(mb, F, B, O, D, obl)
            ops += o + mb * per_row
            byt += trees.tree_bytes(D, O)
    return ops, byt
