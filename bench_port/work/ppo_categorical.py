"""Operations and bytes of a PPO iteration with a shared actor-critic
ensemble on categorical observations: the rollout's forwards and the
update phase.  Each of the Fc features is an int32 code of at most
``cfg["n_codes"]`` values (V); every (feature, code) pair is a candidate
split, its right child the rows of that code."""
from __future__ import annotations

from . import trees
from .ppo import GRAD_OPS_PER_ROW_AND_OUTPUT


def _shape(cfg: dict):
    return (cfg["obs_dim"], cfg["n_codes"], cfg["n_actions"] + 1,
            cfg["tree_struct"]["max_depth"])


def rollout(cfg: dict, ctx: dict):
    """Every env step's forward over the ensemble (``ctx["trees"]``) for
    each env, the action sampled from its logits: a code compare per
    level where a numeric walk compares a value."""
    Fc, _, O, D = _shape(cfg)
    h = cfg["hyper"]
    E = cfg["n_envs"]
    ops, byt = 0, 0
    for _ in range(h["n_steps"] + 1):               # + the bootstrap values
        o, b = trees.walk(E, Fc, ctx["trees"], D, O)
        ops += o + E * 4 * O
        byt += b
    # the trees are read once for the whole rollout
    byt -= h["n_steps"] * ctx["trees"] * trees.tree_bytes(D, O)
    return ops, byt


def fit(n: int, Fc: int, V: int, outputs: int, depth: int):
    """(operations, bytes) of one greedy tree on n rows of Fc codes: the
    candidate selection (each row's squared gradient norm, its norm and
    weight added to each of its pairs, a presence test per pair), per
    level the histogram of every node's rows over (feature, code), each
    candidate's score on every node (the left child as the node less the
    right, squared norms, the divisions, the square root), the argmax,
    the routing, the leaf means.  Bytes: codes, gradients and weights
    read, the tree written."""
    nodes = (1 << depth) - 1
    cands = Fc * V
    ops = n * 2 * outputs + 2 * n * Fc + cands               # candidates
    ops += depth * n * Fc * (outputs + 1)                      # histograms
    ops += nodes * cands * (outputs + 1)                       # left sums
    ops += nodes * cands * (6 * outputs + 7)                   # scores
    ops += nodes * cands                                       # argmax
    ops += depth * n                                           # routing
    ops += n * (outputs + 1) + (1 << depth) * outputs          # leaf means
    byt = n * (Fc + outputs + 1) * trees.F32 + trees.tree_bytes(depth,
                                                                outputs)
    return ops, byt


def update(cfg: dict, ctx: dict):
    """One update phase: the rollout's predictions over the trees it
    starts with, then per minibatch the PPO gradients, one tree, and the
    new tree's predictions over the rollout."""
    Fc, V, O, D = _shape(cfg)
    h = cfg["hyper"]
    n = h["n_steps"] * cfg["n_envs"]
    mb = min(h["batch_size"], n)
    U = h["n_epochs"] * -(-n // mb)
    ops, byt = trees.walk(n, Fc, ctx["trees"], D, O)
    byt += n * 5 * trees.F32 + U * mb * 8          # targets and the plan
    for _ in range(U):
        o, b = fit(mb, Fc, V, O, D)
        ops += o + mb * O * GRAD_OPS_PER_ROW_AND_OUTPUT
        byt += b
        o, _ = trees.walk(n, Fc, 1, D, O)
        ops += o
    return ops, byt
