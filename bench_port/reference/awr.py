"""Plain reference of AWR (advantage-weighted regression, Peng et al. 2019,
arXiv:1910.00177) with a Gaussian tree actor of fixed sigma and a tree
value critic (GBRL, arXiv:2407.08250), for the first update steps of a
training run.

It replays a run from its seed: the environments, the first rollout (the
actor holds no tree, so every action is its bias 0 plus Gaussian noise),
TD(lambda) advantages and targets over the replay with a critic that is
all bias (first 0, then the mean of the targets, as the critic is set to
the return scale at once), the minibatch plans, and then the first ``k``
critic trees (regression on the targets) and the first ``k`` actor trees
(the advantage-weighted regression of the action on the batch-standardised
advantages, exp(A / beta) capped at max_weight, each row's gradient
clipped to an L2 norm of max_grad_norm).  The random draws follow the
algorithm's order on one numpy generator seeded by the run's seed: one
normal per env and step for the action noise, then the critic's
minibatch rows and the actor's, uniform with replacement.

Trees and losses are computed in ``dtype`` (float64 for the reference);
the rollout's actions in float32 numpy, the precision they are drawn in.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from .. import compare, envs
from . import trees


def sample_log_std(h: dict, progress: float) -> float:
    """Exploration log sigma, annealed linearly to ``log_std_final``."""
    ls = h["log_std_init"]
    if h.get("log_std_final") is not None:
        ls = ls + (h["log_std_final"] - ls) * min(progress, 1.0)
    return ls


def _td_lambda(R, Term, Trunc, v, vn, h):
    """(advantages, targets) [T, E] in float64, v / vn the values of the
    observations and of the next observations."""
    T, E = R.shape
    delta = R + h["gamma"] * (1.0 - Term) * vn - v
    done = np.maximum(Term, Trunc)
    adv = np.zeros((T, E))
    gae = np.zeros(E)
    for t in reversed(range(T)):
        gae = delta[t] + h["gamma"] * h["gae_lambda"] * (1.0 - done[t]) * gae
        adv[t] = gae
    return adv, adv + v


def first_rollout(env, cfg: dict, seed: int):
    """The first rollout and the replay built from it: returns (data dict,
    the numpy generator after the rollout).  data: obs [B, F], act [B, A],
    ret [B], adv [B] (valid rows only) and the critic's bias."""
    h = cfg["hyper"]
    E = cfg["n_envs"]
    steps = h["n_steps"] // E
    rng = np.random.default_rng(seed)
    obs, _ = env.reset(seed=seed)
    prev_done = np.zeros(E, bool)
    low = np.full(cfg["act_dim"], -cfg["max_action"], np.float32)
    high = -low
    O, A, R, Term, Trunc, Valid = [], [], [], [], [], []
    ls = np.float32(sample_log_std(h, 0.0))
    for _ in range(steps):
        mu = np.zeros((E, cfg["act_dim"]), np.float32)
        noise = rng.standard_normal(mu.shape).astype(np.float32)
        a = np.clip(mu + np.exp(np.full_like(mu, ls)) * noise, low, high)
        next_obs, r, term, trunc, _ = env.step(a)
        O.append(obs)
        A.append(a)
        R.append(r)
        Term.append(term)
        Trunc.append(trunc)
        Valid.append(~prev_done)
        prev_done = np.logical_or(term, trunc)
        obs = next_obs
    R = np.asarray(R, np.float32).astype(np.float64)
    Term = np.asarray(Term, np.float64)
    Trunc = np.asarray(Trunc, np.float64)
    keep = np.asarray(Valid).reshape(-1)
    z = np.zeros_like(R)
    _, ret0 = _td_lambda(R, Term, Trunc, z, z, h)
    bias = float(ret0.reshape(-1)[keep].mean())
    b = np.full_like(R, bias)
    adv, ret = _td_lambda(R, Term, Trunc, b, b, h)
    n = R.size
    data = dict(obs=np.asarray(O, np.float32).reshape(n, -1)[keep],
                act=np.asarray(A, np.float32).reshape(n, -1)[keep]
                .astype(np.float64),
                ret=ret.reshape(-1)[keep], adv=adv.reshape(-1)[keep],
                bias=bias)
    return data, rng


def minibatch_plans(rng, n_rows: int, cfg: dict):
    """(critic plan [Kc, mb], actor plan [Ka, mb]) of one update."""
    h = cfg["hyper"]
    mb = min(h["batch_size"], n_rows)
    c = rng.integers(0, n_rows, (max(h["critic_updates"], 1), mb))
    a = rng.integers(0, n_rows, (max(h["actor_updates"], 1), mb))
    return c, a


def critic_loss_grads(v: torch.Tensor, r: torch.Tensor):
    """0.5 * mean((v - r)^2) and its per-row gradient times the batch."""
    return 0.5 * torch.mean((v - r) ** 2), (v - r)[:, None]


def actor_loss_grads(mu: torch.Tensor, a: torch.Tensor, adv: torch.Tensor,
                     h: dict):
    """The advantage-weighted regression loss of mu and its per-row
    gradient times the batch, clipped per row (fixed sigma)."""
    adv = (adv - adv.mean()) / (adv.std(correction=0) + 1e-8)
    w = torch.exp(torch.clamp(adv / h["beta"], max=math.log(h["max_weight"])))
    loss = torch.mean(w * 0.5 * torch.sum((a - mu) ** 2, dim=-1))
    g = -w[:, None] * (a - mu)
    if h["max_actor_grad_norm"]:
        norms = torch.sqrt(torch.sum(g * g, dim=-1, keepdim=True))
        g = g * torch.clamp(h["max_actor_grad_norm"] / (norms + 1e-8),
                            max=1.0)
    return loss, g


def first_steps(data: dict, plans, cfg: dict, k: int, dtype=torch.float64,
                device="cpu", fault: str = "", follow: dict = None) -> dict:
    """The first ``k`` critic steps and the first ``k`` actor steps.
    Returns, for "critic" and "actor": predictions over the replay before
    each step and after the last ([k + 1, B, 1]), each step's loss and the
    trees.
    ``fault`` plants a fault to be measured and ``follow`` (the program's
    first k trees of each role) settles ties, as in reference/ppo.py."""
    h = cfg["hyper"]
    ts = cfg["tree_struct"]
    X = torch.as_tensor(data["obs"], device=device)
    B = X.shape[0]
    fw = torch.as_tensor(cfg["feature_weights"], device=device).to(dtype)

    def col(name):
        return torch.as_tensor(data[name], device=device).to(dtype)

    ret, adv, act = col("ret"), col("adv"), col("act")
    out = {}
    for role, plan, lr in (("critic", plans[0], h["critic_lr"]),
                           ("actor", plans[1], h["actor_lr"])):
        P = torch.full((B, 1), data["bias"] if role == "critic" else 0.0,
                       dtype=dtype, device=device)
        preds, losses, fitted = [P], [], []
        for u in range(k):
            idx = torch.as_tensor(plan[u], device=device)
            if role == "critic":
                loss, g = critic_loss_grads(P[idx, 0], ret[idx])
            else:
                loss, g = actor_loss_grads(P[idx], act[idx], adv[idx], h)
            w = torch.ones(len(idx), dtype=dtype, device=device)
            if fault == "half_batch":
                w = w * (torch.arange(len(idx), device=device)
                         < len(idx) // 2)
            tree = trees.fit_tree(X[idx], g, w, fw, ts["max_depth"],
                                  ts["n_bins"],
                                  cfg["params"]["split_score_func"],
                                  ts["grow_policy"] == "oblivious", dtype,
                                  follow[role][u] if follow else None)
            if fault != "unchanged":
                P = P - lr * trees.tree_values(X, tree, ts["max_depth"])
            preds.append(P)
            losses.append(loss)
            fitted.append(tree)
        out[role] = dict(preds=torch.stack(preds), losses=torch.stack(losses),
                         trees=fitted)
    return out


def replay_rows(cfg: dict, seed: int, chunk_actions: list) -> list:
    """The valid rows the replay holds at each iteration of a run whose
    rollouts took ``chunk_actions`` ([steps, E, A] each): the envs are
    replayed from the seed with those actions (a row after an episode's
    end is the autoreset's and not valid), and the oldest rollouts leave
    the replay as the algorithm evicts them (more than ``buffer_size``
    rows held)."""
    h = cfg["hyper"]
    env = envs.make(cfg["env"], cfg["n_envs"])
    env.reset(seed=seed)
    prev_done = np.zeros(cfg["n_envs"], bool)
    held, out = [], []
    for acts in chunk_actions:
        valid = 0
        for a in acts:
            _, _, term, trunc, _ = env.step(a)
            valid += int(np.sum(~prev_done))
            prev_done = np.logical_or(term, trunc)
        held.append((acts.shape[0] * acts.shape[1], valid))
        while sum(n for n, _ in held) > h["buffer_size"] and len(held) > 1:
            held.pop(0)
        out.append(sum(v for _, v in held))
    return out


def rollout_noise(seed: int, cfg: dict, rows: list) -> np.ndarray:
    """The action noise [steps, E, A] (float32) of rollout ``len(rows)``
    (0-based): the generator replayed through every earlier rollout's
    noise and its update's two plans, drawn over ``rows[i]`` replay rows
    at iteration i."""
    h = cfg["hyper"]
    E = cfg["n_envs"]
    steps = h["n_steps"] // E
    rng = np.random.default_rng(seed)
    for n_rows in rows:
        for _ in range(steps):
            rng.standard_normal((E, cfg["act_dim"]))
        minibatch_plans(rng, n_rows, cfg)
    return np.stack([rng.standard_normal((E, cfg["act_dim"]))
                     .astype(np.float32) for _ in range(steps)])


def rollout_actions(obs: np.ndarray, noise: np.ndarray, ens: dict,
                    cfg: dict, progress: float, dtype=torch.float64,
                    device="cpu") -> torch.Tensor:
    """The actions a rollout takes [n, A]: the actor's mean over the trees
    of ``ens`` plus sigma times the noise, clipped to the action range."""
    h = cfg["hyper"]
    mu = trees.predict(obs, ens, [-h["actor_lr"]] * cfg["act_dim"],
                       cfg["tree_struct"]["max_depth"], dtype, device)
    sigma = float(np.exp(np.float32(sample_log_std(h, progress))))
    a = mu + sigma * torch.as_tensor(noise, device=device).to(dtype)
    m = cfg["max_action"]
    return torch.clamp(a, -m, m)


def inputs(cfg: dict, seed: int):
    """The first rollout's replay of a run with this seed and its first
    update's plans: (data, (critic plan, actor plan))."""
    data, rng = first_rollout(envs.make(cfg["env"], cfg["n_envs"]), cfg,
                              seed)
    return data, minibatch_plans(rng, len(data["obs"]), cfg)


def stand_in(cfg: dict, seed: int, k: int, dtype=torch.float64,
             device="cpu", fault: str = "") -> dict:
    """The reference in the program's place, in the readings' format of
    agents/awr.py ``readings``: for the control (a lower ``dtype``) and the
    planted faults.  Its rollout is the first replay's rows, acted on by
    its own actor trees with the second rollout's noise; its replay values
    are its own critic trees' over those rows."""
    h = cfg["hyper"]
    data, plans = inputs(cfg, seed)
    run = first_steps(data, plans, cfg, k, dtype, device, fault)
    ens = trees.stack(run["actor"]["trees"], np.zeros(cfg["act_dim"]))
    B = len(data["obs"])
    noise = rollout_noise(seed, cfg, [B]).reshape(-1, cfg["act_dim"])[:B]
    progress = h["n_steps"] / cfg["total_timesteps"]
    a = rollout_actions(data["obs"], noise, ens, cfg, progress, dtype,
                        device)
    critic = trees.stack(run["critic"]["trees"], [data["bias"]])
    v = trees.predict(data["obs"], critic, [-h["critic_lr"]],
                      cfg["tree_struct"]["max_depth"], dtype, device)
    return dict(critic=run["critic"]["preds"].to(torch.float64).cpu().numpy(),
                actor=run["actor"]["preds"].to(torch.float64).cpu().numpy(),
                first_trees={role: trees.unstack(run[role]["trees"])
                             for role in ("critic", "actor")},
                rollout=dict(obs=data["obs"], actions=a.to(torch.float64)
                             .cpu().numpy(), noise=noise, progress=progress),
                trees=ens,
                replay=dict(obs=data["obs"], values=v[:, 0].to(torch.float64)
                            .cpu().numpy(), trees=critic))


def train_check(readings: dict, cfg: dict, seed: int, k: int,
                device="cpu") -> dict:
    """The numbers that decide a training cell's ``correct``: the first k
    critic and actor steps' losses, the first step's gradient norm and the
    change after k steps per leaf (critic, actor), and the forwards: the
    last rollout's actions from the actor trees that served it, and the
    replay's values from the critic trees its caches stand for."""
    h = cfg["hyper"]
    data, plans = inputs(cfg, seed)
    ref = first_steps(data, plans, cfg, k, torch.float64, device,
                      follow=readings["first_trees"])
    ret = torch.as_tensor(data["ret"], device=device)
    adv = torch.as_tensor(data["adv"], device=device)
    act = torch.as_tensor(data["act"], device=device)
    prog_losses, ref_losses = [], []
    g_ref, g_prog, c_ref, c_prog = {}, {}, {}, {}
    lr = {"critic": h["critic_lr"], "actor": h["actor_lr"]}
    for role, plan in (("critic", plans[0]), ("actor", plans[1])):
        P_ref = ref[role]["preds"].cpu().numpy()
        P_prog = np.asarray(readings[role], np.float64)
        for u in range(k):
            idx = torch.as_tensor(plan[u], device=device)
            P = torch.as_tensor(P_prog[u], device=device)[idx]
            loss = (critic_loss_grads(P[:, 0], ret[idx])[0] if role == "critic"
                    else actor_loss_grads(P, act[idx], adv[idx], h)[0])
            prog_losses.append(float(loss))
        ref_losses += ref[role]["losses"].cpu().numpy().tolist()
        rows = plan[0]
        g_ref[role] = np.linalg.norm((P_ref[1] - P_ref[0])[rows]) / lr[role]
        g_prog[role] = np.linalg.norm((P_prog[1] - P_prog[0])[rows]) / lr[role]
        c_ref[role] = float(np.linalg.norm(P_ref[k] - P_ref[0]))
        c_prog[role] = float(np.linalg.norm(P_prog[k] - P_prog[0]))
    kept = compare.kept_leaves(g_ref)
    ro = readings["rollout"]
    noise, progress = ro.get("noise"), ro.get("progress")
    if noise is None:
        chunks = ro["chunk_actions"]
        rows = replay_rows(cfg, seed, chunks)
        noise = rollout_noise(seed, cfg, rows[:-1]).reshape(
            -1, cfg["act_dim"])
        progress = (len(chunks) - 1) * h["n_steps"] / cfg["total_timesteps"]
    a = rollout_actions(ro["obs"], noise, readings["trees"], cfg, progress,
                        torch.float64, device)
    rp = readings["replay"]
    v = trees.predict(rp["obs"], rp["trees"], [-h["critic_lr"]],
                      cfg["tree_struct"]["max_depth"], torch.float64, device)
    return dict(loss_gap=compare.loss_gap(prog_losses, ref_losses),
                grad_gap=compare.norm_gap(g_prog, g_ref, kept),
                change_gap=compare.norm_gap(c_prog, c_ref, kept),
                forward_gap=max(
                    compare.forward_gap(ro["actions"], a.cpu().numpy()),
                    compare.forward_gap(rp["values"],
                                        v[:, 0].cpu().numpy())))


def serve_outputs(cfg: dict, obs: np.ndarray, ens: dict,
                  dtype=torch.float64, device="cpu"):
    """What a request's call returns: (mean action [N, A], log sigma
    [N, A]) over every tree of ``ens`` (heap arrays and bias)."""
    h = cfg["hyper"]
    mu = trees.predict(obs, ens, [-h["actor_lr"]] * cfg["act_dim"],
                       cfg["tree_struct"]["max_depth"], dtype, device)
    mu = mu.to(torch.float64).cpu().numpy()
    return mu, np.full_like(mu, h["log_std_init"])
