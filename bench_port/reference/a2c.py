"""Plain reference of A2C with a shared actor-critic tree ensemble, an Adam
optimizer on the policy columns, SGD on the value column and gradient
control variates (GBRL, arXiv:2407.08250; the repo's BASELINE config 4),
for the first updates of a training run.

A2C fits one tree a rollout, so the first ``k`` trees come from the first
``k`` rollouts.  The reference replays a run from its seed, rollout by
rollout: the environments; the forwards of the trees so far over the
rollout's rows and its bootstrap observation (none in the first rollout:
every forward is the bias, zeros); GAE(lambda) returns; the A2C loss and
its gradients; from the second tree on, the control-variate correction;
one oblivious tree (reference/trees.py).  The random draws follow the
program's order on one numpy generator seeded by the run's seed: one
uniform per env and step to sample the action.  In the check the envs are
stepped with the program's actions (``actions``), each held to its
uniform's interval of the reference's cumulative probabilities
(``action_gap``); a stand-in samples its own.

The A2C loss (the port's fused update, rl/jit_a2c.py): over rows of weight
w (0 on a row where the env reset, else 1) and n_w = max(sum w, 1), the
advantage normalised as (adv - mean) / (std + 1e-8) with the weighted
mean and the unbiased std; minus sum w adv log pi(a) / n_w, plus ent_coef
times minus the weighted mean entropy, plus vf_coef * 0.5 times the
weighted mean squared error of the value; its gradient with respect to
the ensemble's outputs, times N, the rollout's rows.

Control variates (fitter.cpp:585-633): a row's momentum is the moving
average of the raw leaf values it reaches, tree by tree in order, m =
beta m + (1 - beta) v_t from m = 0, divided by sqrt(1 - beta^T) after T
trees; per column alpha = cov(g, m) / var(m) over the rows (n - 1
denominators; 0 where var(m) is 0), clipped to [-1, 1]; the gradients
become g - alpha (m - mean m).  None while the ensemble holds no tree.

Predictions: the bias, minus value_lr times each tree's value leaf, and on
the policy columns minus Adam's steps, written as the per-row recurrence
(optimizer.cpp:260-283): from m = v = 0 in every prediction, tree t in
order, m = b1 m + (1 - b1) g_t, v = b2 v + (1 - b2) g_t^2, and the step
alpha_t m / (sqrt(v) + eps), alpha_t = lr sqrt(1 - b2^(t+1)) / (1 -
b1^(t+1)), g_t the raw leaf value.

Departures from the published description (the port's conventions, the C++
core's where the port follows it):
- the momentum is divided by sqrt(1 - beta^T), as the C++ core does, where
  a bias-corrected moving average divides by 1 - beta^T;
- a row where the env reset stays in the fit with weight 1 and a raw
  gradient of 0 (after the correction, minus alpha times its centred
  momentum), and the gradients are scaled by N, not by n_w;
- a tree is fit on the whole rollout, every row of weight 1, with no L2
  standardisation (the cosine score).

Everything the trees, the losses and the predictions compute is in
``dtype``: float64 for the reference (TF32 off), a lower precision for the
control, whose sums round once a tree.  The rollout's sampling is float32
numpy, the precision the program draws its actions in.
"""
from __future__ import annotations

import contextlib
import math

import numpy as np
import torch

from .. import compare, envs
from . import trees


@contextlib.contextmanager
def _no_tf32():
    m, c = torch.backends.cuda.matmul, torch.backends.cudnn
    old = m.allow_tf32, c.allow_tf32
    m.allow_tf32 = c.allow_tf32 = False
    try:
        yield
    finally:
        m.allow_tf32, c.allow_tf32 = old


# ------------------------------------------------------------ predictions
def _ensemble(fitted: list, cfg: dict, dtype, device) -> dict:
    """Fitted trees (reference/trees.py's dicts) as one ensemble of tensors
    [T, ...] with the bias (zeros)."""
    D, O = cfg["tree_struct"]["max_depth"], cfg["output_dim"]
    if not fitted:
        P = (1 << D) - 1
        return dict(feat=torch.zeros((0, P), dtype=torch.int64, device=device),
                    thr=torch.zeros((0, P), device=device),
                    is_split=torch.zeros((0, P), dtype=torch.bool,
                                         device=device),
                    leaf_values=torch.zeros((0, 1 << D, O), dtype=dtype,
                                            device=device),
                    bias=torch.zeros(O, dtype=dtype, device=device))
    ens = {f: torch.stack([t[f] for t in fitted])
           for f in ("feat", "thr", "is_split", "leaf_values")}
    ens["bias"] = torch.zeros(O, dtype=dtype, device=device)
    return ens


def _from_heap(arrs: dict, dtype, device) -> dict:
    """Host heap arrays [T, ...] with a bias as tensors on ``device``."""
    ens = {k: torch.as_tensor(np.asarray(arrs[k]), device=device)
           for k in ("feat", "thr", "is_split")}
    ens["feat"] = ens["feat"].to(torch.int64)
    ens["leaf_values"] = torch.as_tensor(
        np.asarray(arrs["leaf_values"], np.float64), device=device).to(dtype)
    ens["bias"] = torch.as_tensor(np.asarray(arrs["bias"], np.float64),
                                  device=device).to(dtype)
    return ens


def leaf_rows(X: torch.Tensor, ens: dict, depth: int) -> torch.Tensor:
    """The raw leaf values each row reaches in each tree: [N, T, O]."""
    T = ens["feat"].shape[0]
    lv = ens["leaf_values"]
    if T == 0:
        return lv.new_zeros((X.shape[0], 0, lv.shape[-1]))
    leaf = trees.leaf_index(X, ens["feat"], ens["thr"], ens["is_split"],
                            depth)
    return lv[torch.arange(T, device=X.device)[None, :], leaf]


def forward(X: torch.Tensor, ens: dict, cfg: dict, dtype=torch.float64,
            policy: str = "adam") -> torch.Tensor:
    """The ensemble's outputs [N, A + 1] for rows X: the value column by
    SGD, the policy columns by Adam's recurrence (``policy="sgd"``: by
    SGD, the planted fault), tree by tree."""
    h, a = cfg["hyper"], cfg["adam"]
    A, D = cfg["n_actions"], cfg["tree_struct"]["max_depth"]
    g = leaf_rows(X, ens, D).to(dtype)
    N = X.shape[0]
    pol = torch.zeros((N, A), dtype=dtype, device=X.device)
    val = torch.zeros((N,), dtype=dtype, device=X.device)
    m = torch.zeros_like(pol)
    v = torch.zeros_like(pol)
    b1, b2, eps = a["beta_1"], a["beta_2"], a["eps"]
    for t in range(g.shape[1]):
        gt = g[:, t, :A]
        val = val + h["value_lr"] * g[:, t, A]
        if policy == "sgd":
            pol = pol + h["policy_lr"] * gt
            continue
        m = b1 * m + (1.0 - b1) * gt
        v = b2 * v + (1.0 - b2) * gt * gt
        alpha = (h["policy_lr"] * math.sqrt(1.0 - b2 ** (t + 1))
                 / (1.0 - b1 ** (t + 1)))
        pol = pol + alpha * m / (torch.sqrt(v) + eps)
    bias = ens["bias"].to(dtype)
    return torch.cat([bias[None, :A] - pol, (bias[A] - val)[:, None]], dim=1)


def cv_momentum(X: torch.Tensor, ens: dict, cfg: dict,
                dtype=torch.float64) -> torch.Tensor:
    """Each row's control-variate momentum [N, O] over the trees of
    ``ens``, tree by tree."""
    beta = cfg["params"]["cv_beta"]
    g = leaf_rows(X, ens, cfg["tree_struct"]["max_depth"]).to(dtype)
    T = g.shape[1]
    m = torch.zeros_like(g[:, 0])
    for t in range(T):
        m = beta * m + (1.0 - beta) * g[:, t]
    return m / math.sqrt(1.0 - beta ** T)


def cv_adjust(grads: torch.Tensor, mom: torch.Tensor) -> torch.Tensor:
    """The gradients less alpha times the centred momentum, per column."""
    n = grads.shape[0]
    gc = grads - grads.mean(dim=0)
    mc = mom - mom.mean(dim=0)
    var = (mc * mc).sum(dim=0) / max(n - 1, 1)
    cov = (gc * mc).sum(dim=0) / max(n - 1, 1)
    alpha = torch.where(var > 0, cov / torch.where(var > 0, var,
                                                   torch.ones_like(var)),
                        torch.zeros_like(var)).clamp(-1.0, 1.0)
    return grads - alpha[None, :] * mc


def loss_grads(P: torch.Tensor, data: dict, cfg: dict, dtype=torch.float64):
    """The A2C loss at predictions P [n, A + 1] and its gradients times n:
    (loss, grads [n, A + 1])."""
    h = cfg["hyper"]
    A = cfg["n_actions"]
    dev = P.device

    def col(k):
        return torch.as_tensor(np.asarray(data[k], np.float64),
                               device=dev).to(dtype)

    w = col("valid")
    nw = torch.clamp(torch.sum(w), min=1.0)
    adv = col("adv")
    if h["normalize_advantage"]:
        m = torch.sum(adv * w) / nw
        var = torch.sum(w * (adv - m) ** 2) / torch.clamp(nw - 1, min=1.0)
        adv = (adv - m) / (torch.sqrt(var) + 1e-8)
    a = torch.as_tensor(data["actions"], device=dev)
    p = P.to(dtype).detach()
    p.requires_grad_(True)
    with torch.enable_grad():
        logp = torch.log_softmax(p[:, :A], dim=-1)
        lp = logp[torch.arange(len(a), device=dev), a]
        ent = -torch.sum(torch.exp(logp) * logp, dim=-1)
        val = h["vf_coef"] * 0.5 * torch.sum(w * (col("ret") - p[:, A]) ** 2)
        loss = (-torch.sum(w * adv * lp) - h["ent_coef"] * torch.sum(w * ent)
                + val) / nw
        (grad,) = torch.autograd.grad(loss, p)
    return loss.detach(), grad * p.shape[0]


# ---------------------------------------------------------------- rollouts
def _start(cfg: dict, seed: int) -> dict:
    """A run's envs, generator, observations and done flags at its start."""
    env = envs.make(cfg["env"], cfg["n_envs"])
    obs, _ = env.reset(seed=seed)
    return dict(env=env, rng=np.random.default_rng(seed), obs=obs,
                dones=np.zeros(cfg["n_envs"], np.float32))


def _sample(preds: np.ndarray, u: np.ndarray, A: int) -> np.ndarray:
    """The program's draw, in float32 numpy: the first action whose
    cumulative probability exceeds the uniform."""
    logits = preds[:, :A] - preds[:, :A].max(axis=1, keepdims=True)
    logp = logits - np.log(np.exp(logits).sum(axis=1, keepdims=True))
    a = (u[:, None] >= np.cumsum(np.exp(logp), axis=1)).sum(axis=1)
    return np.clip(a, 0, A - 1)


def _rollout(st: dict, cfg: dict, policy=None, actions=None) -> dict:
    """One rollout from the state ``st`` (advanced in place): observations
    [n, F] (the bootstrap observation apart), actions, rewards, the done
    flags each step starts with and the uniforms, flat [n].  The actions
    are ``actions`` [n] where given, else drawn from ``policy(obs)``
    ([E, A + 1] float32 predictions; the bias, zeros, without one)."""
    h = cfg["hyper"]
    E, T, A = cfg["n_envs"], h["n_steps"], cfg["n_actions"]
    if actions is not None:
        actions = np.asarray(actions, np.int64).reshape(T, E)
    out = {k: [] for k in ("obs", "acts", "rews", "dns", "us")}
    obs, dones = st["obs"], st["dones"]
    for t in range(T):
        u = st["rng"].random(E)
        if actions is not None:
            a = actions[t]
        else:
            preds = (np.zeros((E, A + 1), np.float32) if policy is None
                     else policy(obs))
            a = _sample(preds, u, A)
        next_obs, r, term, trunc, _ = st["env"].step(a)
        for k, x in zip(out, (obs, a, r, dones, u)):
            out[k].append(np.asarray(x))
        obs, dones = next_obs, np.logical_or(term, trunc).astype(np.float32)
    st["obs"], st["dones"] = obs, dones
    return {k: np.concatenate(v) if k == "obs" else np.stack(v)
            for k, v in out.items()}


def _returns(roll: dict, values: np.ndarray, last_values: np.ndarray,
             last_dones: np.ndarray, cfg: dict):
    """GAE(lambda) advantages and returns, flat [n], in float64."""
    h = cfg["hyper"]
    rews, dns = roll["rews"], roll["dns"]
    T, E = rews.shape
    V = values.reshape(T, E)
    adv = np.zeros((T, E))
    gae = np.zeros(E)
    nv, nnt = last_values, 1.0 - last_dones.astype(np.float64)
    g, lam = h["gamma"], h["gae_lambda"]
    for t in reversed(range(T)):
        delta = rews[t] + g * nv * nnt - V[t]
        gae = delta + g * lam * nnt * gae
        adv[t] = gae
        nv, nnt = V[t], 1.0 - dns[t].astype(np.float64)
    return adv.reshape(-1), (adv + V).reshape(-1)


def _interval_gap(P: torch.Tensor, actions: np.ndarray, us: np.ndarray,
                  A: int) -> float:
    """The widest distance of a uniform outside its action's interval of
    the cumulative probabilities at predictions P [n, A + 1]."""
    cum = torch.cumsum(torch.softmax(P[:, :A].to(torch.float64), dim=-1),
                       dim=-1).cpu().numpy()
    a = np.asarray(actions, np.int64)
    lo = np.where(a > 0, np.take_along_axis(
        cum, np.maximum(a - 1, 0)[:, None], axis=1)[:, 0], 0.0)
    hi = np.where(a < A - 1, np.take_along_axis(
        cum, a[:, None], axis=1)[:, 0], np.inf)
    return float(np.max(np.maximum(0.0, np.maximum(lo - us, us - hi))))


def replay(cfg: dict, seed: int, k: int, dtype=torch.float64, device="cpu",
           fault: str = "", actions: list = None,
           follow: list = None) -> dict:
    """The first ``k`` rollouts and trees of a run: per update its data,
    the predictions over its rows before its tree, its loss and its tree;
    the trees the ensemble holds after the k updates; the widest
    ``action_gap`` of the given ``actions`` (one [n] array a rollout).
    ``fault`` plants one of the faults the check must catch:
    ``"unchanged"`` adds no tree, ``"half_batch"`` fits each tree on the
    first half of its rollout, ``"sgd_policy"`` predicts the policy
    columns by SGD, ``"no_cv"`` fits on the uncorrected gradients.
    ``follow``, the program's first k trees, settles ties
    (reference/trees.py)."""
    h, ts = cfg["hyper"], cfg["tree_struct"]
    A, D = cfg["n_actions"], ts["max_depth"]
    mode = "sgd" if fault == "sgd_policy" else "adam"
    st = _start(cfg, seed)
    served, fitted, updates = [], [], []
    gap = 0.0
    for u in range(k):
        ens = _ensemble(served, cfg, dtype, device)

        def policy(obs):
            with _no_tf32():
                P = forward(torch.as_tensor(obs, device=device), ens, cfg,
                            dtype, mode)
            return P.to(torch.float32).cpu().numpy()
        roll = _rollout(st, cfg, policy if served else None,
                        None if actions is None else actions[u])
        X = torch.as_tensor(np.concatenate([roll["obs"], st["obs"]]),
                            device=device)
        n = len(roll["obs"])
        with _no_tf32():
            P_all = forward(X, ens, cfg, dtype, mode)
        P, X = P_all[:n], X[:n]
        if actions is not None:
            gap = max(gap, _interval_gap(P, roll["acts"].reshape(-1),
                                         roll["us"].reshape(-1), A))
        values = P_all[:, A].to(torch.float64).cpu().numpy()
        adv, ret = _returns(roll, values[:n], values[n:], st["dones"], cfg)
        data = dict(obs=roll["obs"], actions=roll["acts"].reshape(-1),
                    valid=1.0 - roll["dns"].reshape(-1).astype(np.float64),
                    adv=adv, ret=ret)
        with _no_tf32():
            loss, g = loss_grads(P, data, cfg, dtype)
            if served and h["control_variates"] and fault != "no_cv":
                g = cv_adjust(g, cv_momentum(X, ens, cfg, dtype))
            w = torch.ones(n, dtype=dtype, device=device)
            if fault == "half_batch":
                w = w * (torch.arange(n, device=device) < n // 2)
            tree = trees.fit_tree(X, g, w, torch.ones(X.shape[1], dtype=dtype,
                                                      device=device),
                                  D, ts["n_bins"],
                                  cfg["params"]["split_score_func"],
                                  ts["grow_policy"] == "oblivious", dtype,
                                  follow[u] if follow else None)
        fitted.append(tree)
        if fault != "unchanged":
            served.append(tree)
        updates.append(dict(data=data, P=P, loss=loss))
    return dict(updates=updates, fitted=fitted, served=served,
                action_gap=gap, mode=mode)


def prefix_preds(X: np.ndarray, served: list, k: int, cfg: dict,
                 dtype=torch.float64, device="cpu",
                 policy: str = "adam") -> np.ndarray:
    """Predictions over rows X with the first t trees of ``served``, t = 0
    .. k: [k + 1, N, A + 1] float64."""
    Xt = torch.as_tensor(X, device=device)
    out = []
    for t in range(k + 1):
        with _no_tf32():
            P = forward(Xt, _ensemble(served[:t], cfg, dtype, device), cfg,
                        dtype, policy)
        out.append(P.to(torch.float64).cpu().numpy())
    return np.stack(out)


def rollout_forwards(obs: np.ndarray, actions: np.ndarray, ens: dict,
                     cfg: dict, dtype=torch.float64, device="cpu",
                     policy: str = "adam"):
    """Values and log-probabilities of the taken actions, as the rollout's
    forwards give them, over the trees of ``ens`` (heap arrays [T, ...]
    with its bias): (values [n], log_probs [n])."""
    A = cfg["n_actions"]
    with _no_tf32():
        P = forward(torch.as_tensor(obs, device=device),
                    _from_heap(ens, dtype, device), cfg, dtype, policy)
    logp = torch.log_softmax(P[:, :A], dim=-1)
    a = torch.as_tensor(np.asarray(actions, np.int64), device=device)
    return P[:, A], logp[torch.arange(len(a), device=device), a]


def inputs(cfg: dict, seed: int):
    """The first rollout of a run with this seed, drawn with the bias
    alone: (data with its observations ``obs`` [n, F], the run's state
    after it)."""
    st = _start(cfg, seed)
    roll = _rollout(st, cfg)
    return dict(obs=roll["obs"], actions=roll["acts"].reshape(-1)), st


def stand_in(cfg: dict, seed: int, k: int, dtype=torch.float64,
             device="cpu", fault: str = "") -> dict:
    """The reference in the program's place, in the readings' format of
    agents/a2c.py ``readings``: for the control (a lower ``dtype``) and
    the planted faults (``replay``'s, and ``"altered"``: one value of the
    last rollout's forwards plus 1).  Its last rollout is its first, its
    forwards over its own k trees."""
    run = replay(cfg, seed, k, dtype, device, fault)
    X1 = run["updates"][0]["data"]
    ens = trees.stack(run["fitted"], np.zeros(cfg["output_dim"]))
    v, lp = rollout_forwards(X1["obs"], X1["actions"], ens, cfg, dtype,
                             device, run["mode"])
    values = v.to(torch.float64).cpu().numpy()
    if fault == "altered":
        values[len(values) // 2] += 1.0
    return dict(preds=prefix_preds(X1["obs"], run["served"], k, cfg, dtype,
                                   device, run["mode"]),
                pre=np.stack([u["P"].to(torch.float64).cpu().numpy()
                              for u in run["updates"]]),
                actions=[u["data"]["actions"] for u in run["updates"]],
                first_trees=trees.unstack(run["fitted"]),
                rollout=dict(obs=X1["obs"], actions=X1["actions"],
                             values=values,
                             log_probs=lp.to(torch.float64).cpu().numpy()),
                trees=ens)


def train_check(readings: dict, cfg: dict, seed: int, k: int,
                device="cpu") -> dict:
    """The numbers that decide a training cell's ``correct``: the first k
    updates' losses at the program's predictions, the first tree's change
    per leaf (policy, value) over the first rollout, the change after k
    trees, the last rollout's forwards over the trees that served it, and
    the program's actions of the first k rollouts against their uniforms
    (``action_gap``)."""
    ref = replay(cfg, seed, k, torch.float64, device,
                 actions=readings["actions"], follow=readings["first_trees"])
    X1 = inputs(cfg, seed)[0]["obs"]
    P_ref = prefix_preds(X1, ref["served"], k, cfg, torch.float64, device)
    P_prog = np.asarray(readings["preds"], np.float64)
    prog_losses = [float(loss_grads(
        torch.as_tensor(np.asarray(readings["pre"][u], np.float64),
                        device=device), ref["updates"][u]["data"], cfg)[0])
        for u in range(k)]
    ref_losses = [float(u["loss"]) for u in ref["updates"]]
    A = cfg["n_actions"]
    leaves = {"policy": list(range(A)), "value": [A]}
    lr = {"policy": cfg["hyper"]["policy_lr"],
          "value": cfg["hyper"]["value_lr"]}
    g_ref = compare.norms(P_ref[1] - P_ref[0], leaves, lr)
    g_prog = compare.norms(P_prog[1] - P_prog[0], leaves, lr)
    kept = compare.kept_leaves(g_ref)
    c_ref = compare.norms(P_ref[k] - P_ref[0], leaves)
    c_prog = compare.norms(P_prog[k] - P_prog[0], leaves)
    ro = readings["rollout"]
    v, lp = rollout_forwards(ro["obs"], ro["actions"], readings["trees"], cfg,
                             torch.float64, device)
    return dict(
        loss_gap=compare.loss_gap(prog_losses, ref_losses),
        grad_gap=compare.norm_gap(g_prog, g_ref, kept),
        change_gap=compare.norm_gap(c_prog, c_ref, kept),
        forward_gap=max(compare.forward_gap(ro["values"], v.cpu().numpy()),
                        compare.forward_gap(ro["log_probs"],
                                            lp.cpu().numpy())),
        action_gap=ref["action_gap"])


def serve_outputs(cfg: dict, obs: np.ndarray, ens: dict,
                  dtype=torch.float64, device="cpu"):
    """What a request's call returns: (policy logits [N, A], values [N]),
    over every tree of ``ens`` (heap arrays and bias)."""
    A = cfg["n_actions"]
    with _no_tf32():
        P = forward(torch.as_tensor(obs, device=device),
                    _from_heap(ens, dtype, device), cfg, dtype)
    P = P.to(torch.float64).cpu().numpy()
    return P[:, :A], P[:, A]
