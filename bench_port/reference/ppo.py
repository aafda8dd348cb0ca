"""Plain reference of PPO with a shared actor-critic tree ensemble (GBRL,
arXiv:2407.08250; the clipped surrogate of Schulman et al. 2017), for the
first update steps of a training run.

It replays a run from its seed: the environments, the first rollout
(the ensemble holds no tree yet, so every forward is the bias), GAE(lambda)
returns, the minibatch plan of the first update, and then the first
``k`` minibatch trees, each fit on the PPO gradients of its minibatch
(reference/trees.py) and added with minus its column's learning rate.
The random draws follow the algorithm's order on one numpy generator
seeded by the run's seed: one uniform per env and step to sample the
action, then one permutation of the rollout per epoch.

Everything the trees and the losses compute is in ``dtype``: float64 for
the reference, a lower precision for the control.  The rollout's sampling
is float32 numpy, the precision the actions are drawn in, so that the
reference takes the same actions.
"""
from __future__ import annotations

import numpy as np
import torch

from .. import compare, envs
from . import trees


def first_rollout(env, cfg: dict, seed: int):
    """The first rollout with an ensemble that is all bias (zeros): returns
    (data dict of flat [n] arrays, the numpy generator after the rollout)."""
    h = cfg["hyper"]
    E, T, A = cfg["n_envs"], h["n_steps"], cfg["n_actions"]
    rng = np.random.default_rng(seed)
    obs, _ = env.reset(seed=seed)
    dones = np.zeros(E, np.float32)
    bias = np.zeros(A + 1, np.float32)
    O = np.zeros((T, E, cfg["obs_dim"]), np.float32)
    acts = np.zeros((T, E), np.int64)
    rews = np.zeros((T, E), np.float32)
    dns = np.zeros((T, E), np.float32)
    vals = np.zeros((T, E), np.float32)
    logps = np.zeros((T, E), np.float32)
    for t in range(T):
        preds = np.broadcast_to(bias, (E, A + 1)).astype(np.float32)
        logits = preds[:, :A] - preds[:, :A].max(axis=1, keepdims=True)
        logp = logits - np.log(np.exp(logits).sum(axis=1, keepdims=True))
        u = rng.random(E)
        a = (u[:, None] >= np.cumsum(np.exp(logp), axis=1)).sum(axis=1)
        a = np.clip(a, 0, A - 1)
        next_obs, r, term, trunc, _ = env.step(a)
        O[t], acts[t], rews[t], dns[t] = obs, a, r, dones
        vals[t] = preds[:, A]
        logps[t] = np.take_along_axis(logp, a[:, None], axis=1)[:, 0]
        obs, dones = next_obs, np.logical_or(term, trunc).astype(np.float32)
    last_v = np.full(E, bias[A], np.float64)
    adv = np.zeros((T, E))
    gae = np.zeros(E)
    nv, nnt = last_v, 1.0 - dones.astype(np.float64)
    g, lam = h["gamma"], h["gae_lambda"]
    for t in reversed(range(T)):
        delta = rews[t] + g * nv * nnt - vals[t]
        gae = delta + g * lam * nnt * gae
        adv[t] = gae
        nv, nnt = vals[t], 1.0 - dns[t].astype(np.float64)
    n = T * E
    data = dict(obs=O.reshape(n, -1), actions=acts.reshape(n),
                old_logp=logps.reshape(n).astype(np.float64),
                adv=adv.reshape(n), ret=(adv + vals).reshape(n),
                valid=1.0 - dns.reshape(n).astype(np.float64))
    return data, rng


def minibatch_plan(rng, n: int, n_epochs: int, batch_size: int) -> list:
    """Row indices of each minibatch: one permutation per epoch, cut in
    order into minibatches (a last one of fewer than 2 rows is dropped)."""
    plan = []
    for _ in range(n_epochs):
        perm = rng.permutation(n)
        for s in range(0, n, batch_size):
            if len(perm[s:s + batch_size]) >= 2:
                plan.append(perm[s:s + batch_size])
    return plan


def minibatch_loss_grads(P: torch.Tensor, data: dict, idx, cfg: dict,
                         dtype=torch.float64):
    """The PPO loss of one minibatch at predictions P [n, A + 1] (rows of
    the whole rollout), and its per-row gradients scaled by the real
    minibatch size: (loss, grads [mb, A + 1])."""
    h = cfg["hyper"]
    A = cfg["n_actions"]
    dev = P.device

    def col(k):
        return torch.as_tensor(data[k][idx], device=dev).to(dtype)

    w = col("valid")
    n_real = torch.clamp(torch.sum(w), min=1.0)
    adv = col("adv")
    if h["normalize_advantage"]:
        m = torch.sum(adv * w) / n_real
        var = torch.sum(w * (adv - m) ** 2) / torch.clamp(n_real - 1, min=1)
        adv = (adv - m) / (torch.sqrt(var) + 1e-8)
    a = torch.as_tensor(data["actions"][idx], device=dev)
    p = P[torch.as_tensor(idx, device=dev)].to(dtype).detach()
    p.requires_grad_(True)
    with torch.enable_grad():
        logp = torch.log_softmax(p[:, :A], dim=-1)
        lp = logp[torch.arange(len(a), device=dev), a]
        ratio = torch.exp(lp - col("old_logp"))
        clipped = torch.clamp(ratio, 1 - h["clip_range"], 1 + h["clip_range"])
        pol = -torch.minimum(adv * ratio, adv * clipped)
        ent = -torch.sum(torch.exp(logp) * logp, dim=-1)
        val = h["vf_coef"] * 0.5 * (col("ret") - p[:, A]) ** 2
        loss = torch.sum((pol - h["ent_coef"] * ent + val) * w) / n_real
        (grad,) = torch.autograd.grad(loss, p)
    return loss.detach(), grad * n_real * w[:, None]


def lr_columns(cfg: dict, dtype=torch.float64, device="cpu") -> torch.Tensor:
    """The learning rate of each output column (policy columns, value)."""
    h = cfg["hyper"]
    A = cfg["n_actions"]
    return torch.tensor([h["policy_lr"]] * A + [h["value_lr"]], dtype=dtype,
                        device=device)


def first_steps(data: dict, plan: list, cfg: dict, k: int,
                dtype=torch.float64, device="cpu", fault: str = "",
                follow: list = None) -> dict:
    """The first ``k`` update steps: predictions over the rollout before
    each step and after the last ([k + 1, n, A + 1]), each step's loss at
    the predictions before it, and the trees.  ``fault`` plants one of the
    faults the check must catch, for measuring it: ``"unchanged"`` adds no
    tree, ``"half_batch"`` fits each tree on the first half of its
    minibatch.  ``follow``, the program's first k trees, settles ties
    (reference/trees.py)."""
    ts = cfg["tree_struct"]
    X = torch.as_tensor(data["obs"], device=device)
    n = X.shape[0]
    lr = lr_columns(cfg, dtype, device)
    P = torch.zeros((n, cfg["output_dim"]), dtype=dtype, device=device)
    preds, losses, fitted = [P], [], []
    fw = torch.ones(X.shape[1], dtype=dtype, device=device)
    for u in range(k):
        idx = plan[u]
        loss, g = minibatch_loss_grads(P, data, idx, cfg, dtype)
        w = torch.as_tensor(data["valid"][idx], device=device)
        if fault == "half_batch":
            w = w * (torch.arange(len(idx), device=device) < len(idx) // 2)
        tree = trees.fit_tree(X[torch.as_tensor(idx, device=device)], g, w,
                              fw, ts["max_depth"], ts["n_bins"],
                              cfg["params"]["split_score_func"],
                              ts["grow_policy"] == "oblivious", dtype,
                              follow[u] if follow else None)
        if fault != "unchanged":
            P = P - lr[None, :] * trees.tree_values(X, tree, ts["max_depth"])
        preds.append(P)
        losses.append(loss)
        fitted.append(tree)
    return dict(preds=torch.stack(preds), losses=torch.stack(losses),
                trees=fitted)


def rollout_forwards(obs: np.ndarray, actions: np.ndarray, ens: dict,
                     cfg: dict, dtype=torch.float64, device="cpu"):
    """Values and log-probabilities of the taken actions, as the rollout's
    forwards give them, over the trees of ``ens`` (heap arrays [T, ...])
    with bias ``ens["bias"]``: (values [n], log_probs [n])."""
    A = cfg["n_actions"]
    P = trees.predict(obs, ens, -lr_columns(cfg).numpy(),
                      cfg["tree_struct"]["max_depth"], dtype, device)
    logp = torch.log_softmax(P[:, :A], dim=-1)
    a = torch.as_tensor(actions, device=device)
    return P[:, A], logp[torch.arange(len(a), device=device), a]


def inputs(cfg: dict, seed: int):
    """The first rollout of a run with this seed and its first update's
    minibatch plan: (data, plan)."""
    data, rng = first_rollout(envs.make(cfg["env"], cfg["n_envs"]), cfg,
                              seed)
    h = cfg["hyper"]
    return data, minibatch_plan(rng, len(data["obs"]), h["n_epochs"],
                                h["batch_size"])


def stand_in(cfg: dict, seed: int, k: int, dtype=torch.float64,
             device="cpu", fault: str = "") -> dict:
    """The reference in the program's place, in the readings' format of
    agents/ppo.py ``readings``: for the control (a lower ``dtype``) and the
    planted faults.  Its rollout forwards are its own trees' over the first
    rollout, in ``dtype``."""
    data, plan = inputs(cfg, seed)
    run = first_steps(data, plan, cfg, k, dtype, device, fault)
    trees_ = trees.stack(run["trees"], np.zeros(cfg["output_dim"]))
    v, lp = rollout_forwards(data["obs"], data["actions"], trees_, cfg, dtype,
                             device)
    return dict(preds=run["preds"].to(torch.float64).cpu().numpy(),
                first_trees=trees.unstack(run["trees"]),
                rollout=dict(obs=data["obs"], actions=data["actions"],
                             values=v.to(torch.float64).cpu().numpy(),
                             log_probs=lp.to(torch.float64).cpu().numpy()),
                trees=trees_)


def train_check(readings: dict, cfg: dict, seed: int, k: int,
                device="cpu") -> dict:
    """The numbers that decide a training cell's ``correct``: the first k
    steps' losses, the first step's gradient norm and the change after k
    steps per leaf (policy, value), and the last rollout's forwards over
    the trees that served it."""
    data, plan = inputs(cfg, seed)
    ref = first_steps(data, plan, cfg, k, torch.float64, device,
                      follow=readings["first_trees"])
    P_ref = ref["preds"].cpu().numpy()
    P_prog = np.asarray(readings["preds"], np.float64)
    prog_losses = [float(minibatch_loss_grads(
        torch.as_tensor(P_prog[u], device=device), data, plan[u], cfg)[0])
        for u in range(k)]
    A = cfg["n_actions"]
    leaves = {"policy": list(range(A)), "value": [A]}
    lr = {"policy": cfg["hyper"]["policy_lr"],
          "value": cfg["hyper"]["value_lr"]}
    rows = plan[0]
    g_ref = compare.norms((P_ref[1] - P_ref[0])[rows], leaves, lr)
    g_prog = compare.norms((P_prog[1] - P_prog[0])[rows], leaves, lr)
    kept = compare.kept_leaves(g_ref)
    c_ref = compare.norms(P_ref[k] - P_ref[0], leaves)
    c_prog = compare.norms(P_prog[k] - P_prog[0], leaves)
    ro = readings["rollout"]
    v, lp = rollout_forwards(ro["obs"], ro["actions"], readings["trees"], cfg,
                             torch.float64, device)
    return dict(
        loss_gap=compare.loss_gap(prog_losses, ref["losses"].cpu().numpy()),
        grad_gap=compare.norm_gap(g_prog, g_ref, kept),
        change_gap=compare.norm_gap(c_prog, c_ref, kept),
        forward_gap=max(compare.forward_gap(ro["values"], v.cpu().numpy()),
                        compare.forward_gap(ro["log_probs"],
                                            lp.cpu().numpy())))


def serve_outputs(cfg: dict, obs: np.ndarray, ens: dict,
                  dtype=torch.float64, device="cpu"):
    """What a request's call returns: (policy logits [N, A], values [N]),
    over every tree of ``ens`` (heap arrays and bias)."""
    A = cfg["n_actions"]
    P = trees.predict(obs, ens, -lr_columns(cfg).numpy(),
                      cfg["tree_struct"]["max_depth"], dtype, device)
    P = P.to(torch.float64).cpu().numpy()
    return P[:, :A], P[:, A]
