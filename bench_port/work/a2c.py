"""Operations and bytes of an A2C iteration with a shared actor-critic
ensemble whose policy columns take Adam and whose value column takes SGD,
with gradient control variates: the rollout's forwards, the update, and
the Adam delta alone (what ``adam_roofline_pct`` reads).

Every walk routes a row through each live tree once (``depth`` compares);
per row, tree and column the value takes a multiply and an add, Adam's
recurrence ``ADAM_OPS`` and the control-variate momentum a multiply and an
add.  Bytes: the rows and each tree's nodes and the leaf columns read are
read once, the outputs written once."""
from __future__ import annotations

from . import trees
from .ppo import GRAD_OPS_PER_ROW_AND_OUTPUT

# per row, tree and Adam column: m = b1 m + (1 - b1) g (3), v = b2 v +
# (1 - b2) g^2 (4), then sqrt, + eps, divide, times alpha_t, accumulate (5)
ADAM_OPS = 12
# per row and column of the control-variate correction: the centred
# gradient and momentum, the two products summed for var and cov, the
# subtraction of alpha times the centred momentum
CV_ADJUST_OPS = 8


def _shape(cfg: dict):
    return (cfg["obs_dim"], cfg["tree_struct"]["n_bins"], cfg["n_actions"],
            cfg["tree_struct"]["max_depth"],
            cfg["tree_struct"]["grow_policy"] == "oblivious")


def _nodes_bytes(depth: int) -> int:
    return ((1 << depth) - 1) * (trees.F32 + trees.F32 + 1)


def _leaf_bytes(depth: int, columns: int) -> int:
    return (1 << depth) * columns * trees.F32


def adam(cfg: dict, rows: int, n_trees: int):
    """(operations, bytes) of the Adam delta over the policy columns for
    ``rows`` rows and ``n_trees`` live trees: the routing and the
    recurrence; the rows, the trees' nodes and policy leaves read, the
    delta written."""
    F, _, A, D, _ = _shape(cfg)
    ops = rows * n_trees * (D + A * ADAM_OPS)
    byt = (rows * (F + A) * trees.F32
           + n_trees * (_nodes_bytes(D) + _leaf_bytes(D, A)))
    return ops, byt


def forward(cfg: dict, rows: int, n_trees: int):
    """(operations, bytes) of one forward: the Adam policy columns, the
    SGD value column (a multiply and an add a tree) and the value's
    write."""
    ops, byt = adam(cfg, rows, n_trees)
    D = cfg["tree_struct"]["max_depth"]
    ops += rows * n_trees * 2
    byt += n_trees * _leaf_bytes(D, 1) + rows * trees.F32
    return ops, byt


def rollout(cfg: dict, ctx: dict):
    """Every env step's forward over the ensemble (``ctx["trees"]``) for
    each env, the action sampled from its logits, and the bootstrap
    forward."""
    h = cfg["hyper"]
    E = cfg["n_envs"]
    O = cfg["n_actions"] + 1
    D = cfg["tree_struct"]["max_depth"]
    T = ctx["trees"]
    ops, byt = 0, 0
    for _ in range(h["n_steps"] + 1):
        o, b = forward(cfg, E, T)
        ops += o + E * 4 * O
        byt += b
    # the trees are read once for the whole rollout
    byt -= h["n_steps"] * T * (_nodes_bytes(D) + _leaf_bytes(D, O))
    return ops, byt


def update(cfg: dict, ctx: dict):
    """One update on the rollout's n rows: the forward over the trees it
    starts with, the A2C gradients, the control-variate momentum over
    those trees (every column) and the correction, one tree."""
    F, B, A, D, obl = _shape(cfg)
    h = cfg["hyper"]
    O = A + 1
    n = h["n_steps"] * cfg["n_envs"]
    T = ctx["trees"]
    ops, byt = forward(cfg, n, T)
    byt += n * 4 * trees.F32                       # actions, adv, ret, valid
    ops += n * O * GRAD_OPS_PER_ROW_AND_OUTPUT
    if h["control_variates"] and T > 0:
        # the routing is the forward's; the momentum reads every column
        ops += n * T * O * 2 + n * O * CV_ADJUST_OPS
        byt += T * _leaf_bytes(D, O - A)
    o, b = trees.fit(n, F, B, O, D, obl)
    return ops + o, byt + b
