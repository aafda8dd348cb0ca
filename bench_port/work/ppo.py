"""Operations and bytes of a PPO iteration with a shared actor-critic
ensemble: the rollout's forwards and the update phase."""
from __future__ import annotations

from . import trees

# per row of a minibatch: log-softmax over the actions, the ratio, the
# clipped surrogate and its gradient, the value loss and its gradient
GRAD_OPS_PER_ROW_AND_OUTPUT = 12


def _shape(cfg: dict):
    ts = cfg["tree_struct"]
    return (cfg["obs_dim"], ts["n_bins"], cfg["n_actions"] + 1,
            ts["max_depth"], ts["grow_policy"] == "oblivious")


def rollout(cfg: dict, ctx: dict):
    """Every env step's forward over the ensemble (``ctx["trees"]``) for
    each env, the action sampled from its logits."""
    F, _, O, D, _ = _shape(cfg)
    h = cfg["hyper"]
    E = cfg["n_envs"]
    ops, byt = 0, 0
    for _ in range(h["n_steps"] + 1):               # + the bootstrap values
        o, b = trees.walk(E, F, ctx["trees"], D, O)
        ops += o + E * 4 * O
        byt += b
    # the trees are read once for the whole rollout
    byt -= h["n_steps"] * ctx["trees"] * trees.tree_bytes(D, O)
    return ops, byt


def update(cfg: dict, ctx: dict):
    """One update phase: the rollout's predictions over the trees it
    starts with, then per minibatch the PPO gradients, one tree, and the
    new tree's predictions over the rollout."""
    F, B, O, D, obl = _shape(cfg)
    h = cfg["hyper"]
    n = h["n_steps"] * cfg["n_envs"]
    mb = min(h["batch_size"], n)
    U = h["n_epochs"] * -(-n // mb)
    ops, byt = trees.walk(n, F, ctx["trees"], D, O)
    byt += n * 5 * trees.F32 + U * mb * 8          # targets and the plan
    for _ in range(U):
        o, b = trees.fit(mb, F, B, O, D, obl)
        ops += o + mb * O * GRAD_OPS_PER_ROW_AND_OUTPUT
        byt += b
        o, _ = trees.walk(n, F, 1, D, O)
        ops += o
    return ops, byt
