"""Operations and bytes of SAC with a tanh-Gaussian tree actor and twin
parametric-Q tree critics: the rollout's mirror forwards and the fused
gradient steps (8 ensemble sums and 3 tree fits on one minibatch each)."""
from __future__ import annotations

from . import trees

# per row and action column: the draw's scale and shift, tanh, the Gaussian
# log-density, the tanh correction (exp, subtracts, multiplies, log)
SAMPLE_OPS_PER_ACTION = 12
# per row: Q from its parameters (linear form: A multiply-adds and the
# bias) is counted with the action columns; the twin minimum, the entropy
# term and the n-step target y = R + disc * (1 - done) * (...)
TARGET_OPS_PER_ROW = 7
# per row and critic: Q, the squared error and the gradient of every
# parameter column, then the two blocks' norms and clips
CRITIC_OPS_PER_ROW = 16
# per row: the actor loss's gradient through the twin minimum, the sample
# and the log-density, the two blocks' norms and clips
ACTOR_OPS_PER_ROW = 30


def _shape(cfg: dict):
    ts = cfg["tree_struct"]
    A = cfg["act_dim"]
    q = cfg["hyper"]["q_func_type"]
    qdim = A + (2 if q == "quadratic" else 1)
    return (cfg["obs_dim"], ts["n_bins"], A, qdim, ts["max_depth"],
            ts["grow_policy"] == "oblivious")


def prefix(cfg: dict, trees_held: int) -> int:
    """The target prefix of a critic holding ``trees_held`` trees: it moves
    to the tree count each time that reaches a multiple of the interval."""
    k = cfg["hyper"]["target_update_interval"]
    return (trees_held // k) * k


def served_steps(cfg: dict, steps: int) -> int:
    """Vector env steps of one rollout from ``steps`` env steps on that the
    actor's mirror serves (uniform actions before ``learning_starts``)."""
    h = cfg["hyper"]
    E = cfg["n_envs"]
    total = cfg["total_timesteps"]
    return sum(1 for j in range(h["train_freq"])
               if h["learning_starts"] <= steps + j * E < total)


def rollout(cfg: dict, ctx: dict):
    """Every served env step's actor forward (``ctx["actor_trees"]``) for
    each env, the action drawn around it."""
    F, _, A, _, D, _ = _shape(cfg)
    E = cfg["n_envs"]
    n = served_steps(cfg, ctx["steps"])
    if not n:
        return 0, 0
    ops, byt = trees.walk(E, F, ctx["actor_trees"], D, 2 * A)
    ops = n * (ops + E * A * SAMPLE_OPS_PER_ACTION)
    byt = byt + (n - 1) * E * (F + 2 * A) * trees.F32
    return ops, byt


def step(cfg: dict, actor_trees: int, critic_trees: int, prefixes: list):
    """One fused gradient step on a minibatch: the actor over the next
    observations and each critic's target prefix over them
    (``prefixes``), each critic over the observations and its new tree
    fit, the actor over them, each updated critic over them and the
    actor's new tree fit."""
    F, B, A, Q, D, obl = _shape(cfg)
    h = cfg["hyper"]
    N = h["batch_size"]
    C = h["n_critics"]
    # the minibatch in (obs, next obs, action, reward, done, discount) and
    # the noise; its rows are read once for every walk and fit below
    byt = N * (2 * F + 3 * A + 3) * trees.F32
    ops = N * (2 * A * SAMPLE_OPS_PER_ACTION + TARGET_OPS_PER_ROW
               + C * CRITIC_OPS_PER_ROW + ACTOR_OPS_PER_ROW)
    ops += N * C * 2 * (2 * A + 1)                # Q at the target, the loss
    walks = ([(actor_trees, 2 * A)] * 2 + [(p, Q) for p in prefixes]
             + [(critic_trees, Q)] * C + [(critic_trees + 1, Q)] * C)
    for t, O in walks:
        o, b = trees.walk(N, F, t, D, O)
        ops += o
        byt += b - N * F * trees.F32                # rows counted above
    for O in [Q] * C + [2 * A]:
        o, b = trees.fit(N, F, B, O, D, obl)
        ops += o
        byt += b - N * (F + 1) * trees.F32          # rows and weights above
    return ops, byt


def update(cfg: dict, ctx: dict):
    """One train event: ``gradient_steps`` fused steps, each learner one
    tree more at each, the critics' prefixes as they stood at the event's
    start until the interval moves them."""
    ops = byt = 0
    for j in range(cfg["hyper"]["gradient_steps"]):
        c = ctx["critic_trees"] + j
        o, b = step(cfg, ctx["actor_trees"] + j, c,
                    [max(p, prefix(cfg, c)) for p in ctx["prefixes"]])
        ops += o
        byt += b
    return ops, byt
