"""Plain reference of PPO with a shared actor-critic tree ensemble on
categorical observations (GBRL, arXiv:2407.08250: trees split on a
category's equality), for the first update steps that carry a signal and
the update after them.

A fresh agent's ensemble holds only its bias (zeros) until a rollout
holds a reward: before that every advantage and return is 0, so every
gradient, every leaf value and every tree's contribution is exactly 0, and
the policy stays the uniform one.  The reference therefore replays a run
from its seed rollout by rollout with the bias alone: the environments,
the vocabulary rule, the rollouts (one uniform per env and step to sample
the action, on one numpy generator seeded by the run's seed) and each
update's minibatch plan (one permutation of the rollout per epoch), up to
the first rollout that holds a reward, the checked one (the first rollout
where no rollout of the run holds one).  There it fits the first ``k``
minibatch trees, each on the PPO gradients of its minibatch, and adds each
with minus its column's learning rate.

Where that update is not the run's last, the next one is checked too: the
reference fits the whole checked update, steps the environments on with
the program's actions, derives the next rollout's codes, values,
log-probabilities and returns from its own trees, and fits that update's
first ``k`` trees on those predictions.  Its predictions before them walk
the categorical trees the checked update added, the ones the program's
update loads on the card.  Each program action must lie in its uniform's
interval of the reference's cumulative probabilities (``action_gap``).

The vocabulary rule: each observation is encoded once, in the order the
run sees them; per feature, a value not seen before gets the next code,
the new values of one observation batch in sorted order.

The trees: greedy, over equality splits (a row goes right when its code
equals the split's), the candidates every (feature, code) pair present
among the minibatch's weighted rows (the configuration's ``n_bins`` bounds
the candidates per feature, and a code space of at most ``n_bins`` codes
never reaches it); the cosine or L2 score of the children's gradient sums
and counts; a candidate already used on the node's path is blocked; a node
takes its best candidate minus its own score (none at the root) and splits
when that is >= 0 and it holds samples; the argmax is the first index
within the tie band (reference/trees.py); leaves are the weighted mean of
their rows' gradients.  Where the program's trees are given (``follow``),
ties are settled as reference/trees.py settles them.

Everything the trees and the losses compute is in ``dtype``: float64 for
the reference (TF32 off), a lower precision for the control.  The
rollout's sampling is float32 numpy, the precision the actions are drawn
in, so that the reference takes the same actions up to the checked
update; past it a stand-in samples from its own trees the same way.
"""
from __future__ import annotations

import contextlib
import math

import numpy as np
import torch

from .. import compare, envs
from .trees import NEG_INF, TIE_RTOL, _first_argmax, _score


@contextlib.contextmanager
def _no_tf32():
    m, c = torch.backends.cuda.matmul, torch.backends.cudnn
    old = m.allow_tf32, c.allow_tf32
    m.allow_tf32 = c.allow_tf32 = False
    try:
        yield
    finally:
        m.allow_tf32, c.allow_tf32 = old


# ------------------------------------------------------------- vocabulary
def encode_all(seen: list) -> list:
    """The vocabulary rule over observation batches in the order the run
    encodes them: [S] string arrays [E, Fc] -> [S] int64 code arrays."""
    S = len(seen)
    E, Fc = seen[0].shape
    cols = np.stack(seen).astype(str)                    # [S, E, Fc]
    codes = np.empty((S, E, Fc), np.int64)
    for f in range(Fc):
        col = cols[:, :, f].reshape(-1)
        uniq, first, inv = np.unique(col, return_index=True,
                                     return_inverse=True)
        # by the batch a value first shows in, then by the value
        order = np.lexsort((np.arange(len(uniq)), first // E))
        code = np.empty(len(uniq), np.int64)
        code[order] = np.arange(len(uniq))
        codes[:, :, f] = code[inv.reshape(-1)].reshape(S, E)
    return list(codes)


class Vocab:
    """The vocabulary rule one batch at a time, after the batches ``seen``
    (for a rollout whose actions need each step's codes)."""

    def __init__(self, seen: list):
        cols = np.stack(seen).astype(str)
        codes = np.stack(encode_all(seen))
        self.maps = []
        for f in range(cols.shape[2]):
            uniq, first = np.unique(cols[:, :, f], return_index=True)
            self.maps.append(dict(zip(uniq, codes[:, :, f].reshape(-1)[first])))

    def encode(self, batch) -> np.ndarray:
        b = np.asarray(batch).astype(str)
        out = np.empty(b.shape, np.int64)
        for f, m in enumerate(self.maps):
            uniq, inv = np.unique(b[:, f], return_inverse=True)
            for v in uniq:                       # sorted: new ones in order
                m.setdefault(v, len(m))
            out[:, f] = np.array([m[v] for v in uniq])[inv.reshape(-1)]
        return out


# ---------------------------------------------------------------- rollouts
def _sample(preds: np.ndarray, u: np.ndarray, A: int):
    """The rollout's rule in float32 numpy: the action whose interval of
    the cumulative probabilities holds the uniform, and its
    log-probability."""
    p = np.asarray(preds, np.float32)[:, :A]
    logits = p - p.max(axis=1, keepdims=True)
    logp = logits - np.log(np.exp(logits).sum(axis=1, keepdims=True))
    a = (u[:, None] >= np.cumsum(np.exp(logp), axis=1)).sum(axis=1)
    a = np.clip(a, 0, A - 1)
    return a, np.take_along_axis(logp, a[:, None], axis=1)[:, 0]


def _rollout(env, obs, dones, rng, cfg: dict, policy=None, actions=None):
    """One rollout: the observations seen, the arrays [T, E] (actions,
    rewards, the done flags each step starts with, the uniforms, the
    log-probabilities of the sampling) and the env's state after it.  The
    actions are ``actions`` [T, E] where given, else sampled from
    ``policy(obs)`` ([E, A + 1] predictions; the bias, zeros, without
    one)."""
    h = cfg["hyper"]
    E, T, A = cfg["n_envs"], h["n_steps"], cfg["n_actions"]
    O = []
    roll = dict(acts=np.zeros((T, E), np.int64),
                rews=np.zeros((T, E), np.float32),
                dns=np.zeros((T, E), np.float32),
                us=np.zeros((T, E)), logps=np.zeros((T, E), np.float32))
    for t in range(T):
        u = rng.random(E)
        if actions is not None:
            a = np.asarray(actions[t], np.int64)
        else:
            preds = (np.zeros((E, A + 1), np.float32) if policy is None
                     else policy(obs))
            a, roll["logps"][t] = _sample(preds, u, A)
        next_obs, r, term, trunc, _ = env.step(a)
        O.append(obs)
        roll["acts"][t], roll["rews"][t], roll["dns"][t] = a, r, dones
        roll["us"][t] = u
        obs, dones = next_obs, np.logical_or(term, trunc).astype(np.float32)
    return O, roll, obs, dones


def _returns(roll: dict, dones, cfg: dict, values=None, last_values=None):
    """GAE(lambda) advantages and returns [T, E] of a rollout with its
    values [T, E] and the bootstrap values [E] (all the bias, 0, where not
    given)."""
    h = cfg["hyper"]
    rews, dns = roll["rews"], roll["dns"]
    T, E = rews.shape
    V = np.zeros((T, E)) if values is None else np.asarray(values, np.float64)
    adv = np.zeros((T, E))
    gae = np.zeros(E)
    nv = np.zeros(E) if last_values is None else np.asarray(last_values,
                                                            np.float64)
    nnt = 1.0 - dones.astype(np.float64)
    g, lam = h["gamma"], h["gae_lambda"]
    for t in reversed(range(T)):
        delta = rews[t] + g * nv * nnt - V[t]
        gae = delta + g * lam * nnt * gae
        adv[t] = gae
        nv, nnt = V[t], 1.0 - dns[t].astype(np.float64)
    return adv, adv + V


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


def _replay(cfg: dict, seed: int) -> dict:
    """The run with this seed replayed with the bias alone up to its
    checked rollout: that rollout and its update's plan, the observation
    batches seen, and the envs, the generator and the vocabulary's input
    as the update leaves them."""
    h = cfg["hyper"]
    E, T = cfg["n_envs"], h["n_steps"]
    n = T * E
    iters = -(-cfg["total_timesteps"] // n)
    env = envs.make(cfg["env"], E)
    rng = np.random.default_rng(seed)
    obs, _ = env.reset(seed=seed)
    dones = np.zeros(E, np.float32)
    seen, rolls = [], []
    for i in range(iters):
        O, roll, obs, dones = _rollout(env, obs, dones, rng, cfg)
        roll["adv"], roll["ret"] = _returns(roll, dones, cfg)
        roll["plan"] = minibatch_plan(rng, n, h["n_epochs"], h["batch_size"])
        roll["rows"] = (len(seen), len(seen) + T)
        seen.extend(O)
        rolls.append(roll)
        if roll["rews"].any():
            break
    rewarded = bool(rolls[-1]["rews"].any())
    i = len(rolls) - 1 if rewarded else 0
    return dict(roll=rolls[i], update=i, rewarded=rewarded, iters=iters,
                env=env, obs=obs, dones=dones, rng=rng, seen=seen)


def _data(roll: dict, codes: np.ndarray, obs=None) -> dict:
    n = roll["acts"].size
    return dict(obs=obs, codes=codes, actions=roll["acts"].reshape(n),
                old_logp=roll["logps"].reshape(n).astype(np.float64),
                adv=roll["adv"].reshape(n), ret=roll["ret"].reshape(n),
                valid=1.0 - roll["dns"].reshape(n).astype(np.float64))


def inputs(cfg: dict, seed: int, st: dict = None):
    """The checked rollout of a run with this seed and its update's
    minibatch plan: (data, plan).  ``data["obs"]`` holds the rollout's
    string observations [n, Fc], ``data["codes"]`` their codes,
    ``data["update"]`` the update's index in the run.  ``st``: the run's
    replay (``_replay``), where made already."""
    st = st or _replay(cfg, seed)
    roll = st["roll"]
    a, b = roll["rows"]
    seen = st["seen"]
    codes = encode_all(seen + [st["obs"]])     # with the last bootstrap's
    data = _data(roll, np.concatenate(codes[a:b]),
                 np.concatenate(seen[a:b]).astype(str))
    data["update"] = st["update"]
    return data, roll["plan"]


def has_next(st: dict) -> bool:
    """Whether the run's checked update carries a signal and is followed
    by another update."""
    return st["rewarded"] and st["update"] + 1 < st["iters"]


def next_inputs(cfg: dict, st: dict, ens: dict, dtype=torch.float64,
                device="cpu", actions=None):
    """The update after the checked one, the replay ``st`` continued with
    the ensemble ``ens`` (heap arrays with their bias) that the checked
    update left: (data, plan, rollout).  The rollout takes ``actions``
    [n] where given, else samples from ``ens`` in ``dtype``; its codes,
    values and log-probabilities of the actions (``rollout``, [n] each)
    and its returns come from ``ens`` over this vocabulary's codes.
    ``data["P0"]``: the predictions over the rollout that the update
    starts from; ``rollout["action_gap"]``: the widest distance of a
    uniform outside its action's interval of the cumulative
    probabilities."""
    h = cfg["hyper"]
    A, D = cfg["n_actions"], cfg["tree_struct"]["max_depth"]
    E, T = cfg["n_envs"], h["n_steps"]
    n = T * E
    coeff = -lr_columns(cfg).numpy()
    seen = st["seen"]
    policy = None
    if actions is None:
        vocab = Vocab(seen + [st["obs"]])

        def policy(obs):
            with _no_tf32():
                P = predict(vocab.encode(obs), ens, coeff, D, dtype, device)
            return P.to(torch.float32).cpu().numpy()
    else:
        actions = np.asarray(actions, np.int64).reshape(T, E)
    O, roll, obs, dones = _rollout(st["env"], st["obs"], st["dones"],
                                   st["rng"], cfg, policy, actions)
    codes = encode_all(seen + O + [obs])
    C = np.concatenate(codes[len(seen):])                 # rows + bootstrap
    with _no_tf32():
        P = predict(C, ens, coeff, D, dtype, device)
    P = P.to(torch.float64)
    values = P[:, A].cpu().numpy()
    logp = torch.log_softmax(P[:, :A], dim=-1)
    a = torch.as_tensor(roll["acts"].reshape(n), device=P.device)
    lp = logp[torch.arange(n, device=P.device), a]
    roll["logps"] = lp.cpu().numpy().reshape(T, E)
    cum = torch.cumsum(torch.exp(logp[:n]), dim=-1).cpu().numpy()
    lo = np.where(a.cpu().numpy() > 0, np.take_along_axis(
        cum, np.maximum(a.cpu().numpy() - 1, 0)[:, None], axis=1)[:, 0], 0.0)
    hi = np.where(a.cpu().numpy() < A - 1, np.take_along_axis(
        cum, a.cpu().numpy()[:, None], axis=1)[:, 0], np.inf)
    u = roll["us"].reshape(n)
    roll["adv"], roll["ret"] = _returns(roll, dones, cfg,
                                        values[:n].reshape(T, E), values[n:])
    plan = minibatch_plan(st["rng"], n, h["n_epochs"], h["batch_size"])
    data = _data(roll, C[:n])
    data["P0"] = P[:n]
    return data, plan, dict(
        codes=C[:n], actions=roll["acts"].reshape(n), values=values[:n],
        log_probs=lp.cpu().numpy(), action_gap=float(np.max(np.maximum(
            0.0, np.maximum(lo - u, u - hi)))))


# ------------------------------------------------------------------ trees
def fit_tree(C: torch.Tensor, grads: torch.Tensor, w: torch.Tensor,
             depth: int, score: str, dtype=torch.float64,
             follow: dict = None) -> dict:
    """One greedy tree on codes C [N, Fc] (int64, >= 0) with gradients
    [N, O] and 0/1 row weights [N].  Returns heap arrays: feat [2^D - 1]
    (-1 unsplit), cat_code, is_split, leaf_values [2^D, O] (in
    ``dtype``)."""
    N, Fc = C.shape
    O = grads.shape[1]
    dev = C.device
    V = int(C.max()) + 1 if N else 1
    g = grads.to(dtype) * w.to(dtype)[:, None]
    cnt = w.to(dtype)
    right = (C[:, :, None] == torch.arange(V, device=dev)).reshape(N, Fc * V)
    present = (right & (w > 0)[:, None]).any(dim=0)           # [Fc * V]
    right = right.to(dtype)
    rows = torch.cat([g, cnt[:, None]], dim=1)                  # [N, O + 1]
    node = torch.zeros(N, dtype=torch.int64, device=dev)
    blocked = torch.zeros((1, Fc * V), dtype=torch.bool, device=dev)
    n_int = (1 << depth) - 1
    feat = torch.full((n_int,), -1, dtype=torch.int64, device=dev)
    code = torch.full((n_int,), -1, dtype=torch.int64, device=dev)
    split = torch.zeros((n_int,), dtype=torch.bool, device=dev)
    for d in range(depth):
        nn = 1 << d
        oh = (node[:, None] == torch.arange(nn, device=dev)[None]).to(dtype)
        tot = oh.T @ rows                                       # [nn, O + 1]
        per = (oh[:, :, None] * rows[:, None, :]).reshape(N, nn * (O + 1))
        rsum = (per.T @ right).reshape(nn, O + 1, Fc * V).permute(0, 2, 1)
        sr, nr = rsum[..., :O], rsum[..., O]
        sl = tot[:, None, :O] - sr
        nl = tot[:, None, O] - nr
        sc = _score(sl, nl, sr, nr, score)                      # [nn, Fc*V]
        sc = torch.where(blocked | ~present[None],
                         torch.full_like(sc, NEG_INF), sc)
        sc = torch.where(torch.isnan(sc), torch.full_like(sc, NEG_INF), sc)
        scale = None
        if d > 0:
            parent = _score(tot[:, :O], tot[:, O],
                            torch.zeros_like(tot[:, :O]),
                            torch.zeros_like(tot[:, O]), score)
            sc = sc - parent[:, None]
            scale = parent.abs()[:, None]
        best_idx = _first_argmax(sc, scale)
        best = torch.gather(sc, 1, best_idx[:, None])[:, 0]
        do_split = (best >= 0) & (tot[:, O] > 0)
        if follow is not None:
            lo = (1 << d) - 1
            f = torch.as_tensor(follow["feat"][lo:lo + nn], device=dev).long()
            c = torch.as_tensor(follow["cat_code"][lo:lo + nn],
                                device=dev).long()
            fs = torch.as_tensor(follow["is_split"][lo:lo + nn],
                                 device=dev).bool()
            fj = torch.clamp(f, min=0) * V + torch.clamp(c, 0, V - 1)
            ok = (f >= 0) & (c >= 0) & (c < V) & present[fj]
            tol = (best.abs() + (0 if scale is None else scale[:, 0])
                   ) * TIE_RTOL
            got = torch.gather(sc, 1, fj[:, None])[:, 0]
            take = fs & ok & (got >= best - tol) & (got >= -tol) & (
                tot[:, O] > 0)
            stay = ~fs & (best <= tol)
            best_idx = torch.where(take, fj, best_idx)
            do_split = torch.where(take | stay, fs, do_split)
        f_sel, c_sel = best_idx // V, best_idx % V
        lo = (1 << d) - 1
        feat[lo:lo + nn] = torch.where(do_split, f_sel, -1)
        code[lo:lo + nn] = torch.where(do_split, c_sel, -1)
        split[lo:lo + nn] = do_split
        x = torch.gather(C, 1, f_sel[node][:, None])[:, 0]
        go = (x == c_sel[node]) & do_split[node]
        node = node * 2 + go.to(torch.int64)
        chosen = do_split[:, None] & (
            torch.arange(Fc * V, device=dev)[None] == best_idx[:, None])
        rep = torch.arange(2 * nn, device=dev) // 2
        blocked = (blocked | chosen)[rep]
    L = 1 << depth
    oh = (node[:, None] == torch.arange(L, device=dev)[None]).to(dtype)
    leaf = oh.T @ rows
    n_leaf = leaf[:, O]
    values = torch.where(n_leaf[:, None] > 0,
                         leaf[:, :O] / torch.where(n_leaf > 0, n_leaf,
                                                   torch.ones_like(n_leaf)
                                                   )[:, None],
                         torch.zeros_like(leaf[:, :O]))
    return dict(feat=feat, cat_code=code, is_split=split,
                leaf_values=values)


def leaf_index(C: torch.Tensor, feat, code, is_split,
               depth: int) -> torch.Tensor:
    """Heap walk of T trees over codes C [N, Fc]: feat / code / is_split
    [T, 2^D - 1] -> [N, T] leaf indices (right when the code equals the
    split's)."""
    N = C.shape[0]
    T, n_int = feat.shape
    base = (torch.arange(T, device=C.device) * n_int)[None, :]
    ft = feat.reshape(-1).to(torch.int64)
    cc = code.reshape(-1).to(torch.int64)
    sp = is_split.reshape(-1).bool()
    p = torch.zeros((N, T), dtype=torch.int64, device=C.device)
    for _ in range(depth):
        idx = base + p
        f = torch.clamp(ft[idx], min=0)
        go = sp[idx] & (torch.gather(C, 1, f) == cc[idx])
        p = 2 * p + 1 + go.to(torch.int64)
    return p - n_int


def predict(codes, ens: dict, coeff_row, depth: int, dtype=torch.float64,
            device="cpu", chunk: int = 256) -> torch.Tensor:
    """``ens["bias"]`` plus every tree of ``ens`` (host heap arrays [T,
    ...]) times the columns' coefficients ``coeff_row`` [O]: [N, O]."""
    C = torch.as_tensor(np.asarray(codes), device=device).long()
    coeff = torch.as_tensor(np.asarray(coeff_row, np.float64),
                            device=device).to(dtype)
    out = torch.as_tensor(np.asarray(ens["bias"], np.float64),
                          device=device).to(dtype)[None, :].expand(
                              C.shape[0], -1).clone()
    T = ens["feat"].shape[0]
    for t0 in range(0, T, chunk):
        sl = slice(t0, min(T, t0 + chunk))
        dev = {k: torch.as_tensor(ens[k][sl], device=device)
               for k in ("feat", "cat_code", "is_split", "leaf_values")}
        leaf = leaf_index(C, dev["feat"], dev["cat_code"], dev["is_split"],
                          depth)
        w = dev["leaf_values"].to(dtype) * coeff[None, None, :]
        trees = torch.arange(leaf.shape[1], device=device)[None, :]
        vals = w[trees, leaf]                                   # [N, C, O]
        if dtype == torch.float64:
            out = out + vals.sum(dim=1)
        else:
            for c in range(vals.shape[1]):
                out = out + vals[:, c]
    return out


# ------------------------------------------------------------- the update
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
    """The first ``k`` update steps of the checked update: predictions over
    its rollout before each step and after the last ([k + 1, n, A + 1]),
    each step's loss at the predictions before it, and the trees.
    ``fault`` plants one of the faults the check must catch:
    ``"unchanged"`` adds no tree, ``"half_batch"`` fits each tree on the
    first half of its minibatch, ``"code_shift"`` fits on every code plus
    one (a vocabulary that disagrees between the rollout and the fit),
    the predictions walking the rollout's own codes; ``"stale_load"``
    acts in ``stand_in`` alone: the update after the checked one fits from
    the bias, as a load that walks none of the trees before it.  ``follow``, the
    program's first k trees, settles ties.  The update starts from
    ``data["P0"]`` where given, else from the bias (zeros)."""
    ts = cfg["tree_struct"]
    D = ts["max_depth"]
    C = torch.as_tensor(data["codes"], device=device).long()
    Cfit = C + 1 if fault == "code_shift" else C
    n = C.shape[0]
    lr = lr_columns(cfg, dtype, device)
    P = (torch.as_tensor(data["P0"], device=device).to(dtype)
         if data.get("P0") is not None else
         torch.zeros((n, cfg["output_dim"]), dtype=dtype, device=device))
    preds, losses, fitted = [P], [], []
    with _no_tf32():
        for u in range(k):
            idx = plan[u]
            loss, g = minibatch_loss_grads(P, data, idx, cfg, dtype)
            w = torch.as_tensor(data["valid"][idx], device=device)
            if fault == "half_batch":
                w = w * (torch.arange(len(idx), device=device)
                         < len(idx) // 2)
            rows = torch.as_tensor(idx, device=device)
            tree = fit_tree(Cfit[rows], g, w, D,
                            cfg["params"]["split_score_func"], dtype,
                            follow[u] if follow else None)
            if fault != "unchanged":
                leaf = leaf_index(C, tree["feat"][None],
                                  tree["cat_code"][None],
                                  tree["is_split"][None], D)[:, 0]
                P = P - lr[None, :] * tree["leaf_values"][leaf]
            preds.append(P)
            losses.append(loss)
            fitted.append(tree)
    return dict(preds=torch.stack(preds), losses=torch.stack(losses),
                trees=fitted)


def rollout_forwards(codes: np.ndarray, actions: np.ndarray, ens: dict,
                     cfg: dict, dtype=torch.float64, device="cpu"):
    """Values and log-probabilities of the taken actions, as the rollout's
    forwards give them, over the trees of ``ens`` (heap arrays [T, ...]
    with bias ``ens["bias"]``): (values [n], log_probs [n])."""
    A = cfg["n_actions"]
    with _no_tf32():
        P = predict(codes, ens, -lr_columns(cfg).numpy(),
                    cfg["tree_struct"]["max_depth"], dtype, device)
    logp = torch.log_softmax(P[:, :A], dim=-1)
    a = torch.as_tensor(actions, device=device)
    return P[:, A], logp[torch.arange(len(a), device=device), a]


def _heap(fitted: list, bias, lo: int = 0, hi: int = None,
          zero_leaves: bool = False) -> dict:
    """Heap arrays [T, ...] of the trees ``fitted[lo:hi]`` with ``bias``;
    ``zero_leaves`` for a state left unchanged."""
    fitted = fitted[lo:hi]
    out = {k: torch.stack([t[k] for t in fitted]).cpu().numpy()
           for k in ("feat", "cat_code", "is_split")}
    out["leaf_values"] = torch.stack([t["leaf_values"] for t in fitted]) \
        .to(torch.float64).cpu().numpy()
    if zero_leaves:
        out["leaf_values"] = np.zeros_like(out["leaf_values"])
    out["bias"] = np.asarray(bias, np.float64)
    return out


def _splits(trees: list) -> list:
    return [{f: t[f].cpu().numpy() for f in ("feat", "cat_code", "is_split")}
            for t in trees]


def stand_in(cfg: dict, seed: int, k: int, dtype=torch.float64,
             device="cpu", fault: str = "") -> dict:
    """The reference in the program's place, in the readings' format of
    agents/ppo_categorical.py ``readings``: for the control (a lower
    ``dtype``) and the planted faults.  Its rollout forwards are its own
    first k trees' over the checked rollout, in ``dtype``; past the
    checked update it samples its next rollout from its own trees."""
    st = _replay(cfg, seed)
    data, plan = inputs(cfg, seed, st)
    U = len(plan) if has_next(st) else k
    run = first_steps(data, plan, cfg, U, dtype, device, fault)
    zeros = np.zeros(cfg["output_dim"])
    ens = _heap(run["trees"], zeros, 0, k)
    v, lp = rollout_forwards(data["codes"], data["actions"], ens, cfg, dtype,
                             device)
    out = dict(preds=run["preds"][:k + 1].to(torch.float64).cpu().numpy(),
               first_trees=_splits(run["trees"][:k]),
               rollout=dict(codes=data["codes"], actions=data["actions"],
                            values=v.to(torch.float64).cpu().numpy(),
                            log_probs=lp.to(torch.float64).cpu().numpy()),
               trees=ens, next=None)
    if has_next(st):
        ens = _heap(run["trees"], zeros, zero_leaves=fault == "unchanged")
        nd, nplan, ro = next_inputs(cfg, st, ens, dtype, device)
        if fault == "stale_load":
            nd = dict(nd, P0=None)
        nxt = first_steps(nd, nplan, cfg, k, dtype, device, fault)
        trees = run["trees"] + nxt["trees"]
        out["next"] = dict(
            base=U, trees=_heap(trees, zeros,
                                zero_leaves=fault == "unchanged"),
            follow=_splits(trees), actions=ro["actions"],
            values=ro["values"], log_probs=ro["log_probs"])
    return out


def _gaps(P_prog, ref: dict, data: dict, plan: list, cfg: dict, k: int,
          device) -> dict:
    """``loss_gap``, ``grad_gap`` and ``change_gap`` of the program's
    predictions P_prog [k + 1, n, O] over an update's rollout against the
    reference's ``first_steps``."""
    P_ref = ref["preds"].cpu().numpy()
    P_prog = np.asarray(P_prog, np.float64)
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
    return dict(
        loss_gap=compare.loss_gap(prog_losses, ref["losses"].cpu().numpy()),
        grad_gap=compare.norm_gap(g_prog, g_ref, kept),
        change_gap=compare.norm_gap(c_prog, c_ref, kept))


def _walk_prefixes(codes, ens: dict, base: int, k: int, cfg: dict,
                   device) -> np.ndarray:
    """Predictions [k + 1, n, O] over ``codes`` of the first base, base +
    1, ..., base + k trees of ``ens`` (heap arrays with their bias), in
    float64."""
    D = cfg["tree_struct"]["max_depth"]
    coeff = -lr_columns(cfg).numpy()

    def part(lo, hi, bias):
        sub = {f: ens[f][lo:hi] for f in ("feat", "cat_code", "is_split",
                                          "leaf_values")}
        sub["bias"] = bias
        return predict(codes, sub, coeff, D, torch.float64, device)

    with _no_tf32():
        P = part(0, base, ens["bias"])
        out = [P]
        for j in range(k):
            P = P + part(base + j, base + j + 1,
                         np.zeros_like(ens["bias"]))
            out.append(P)
    return torch.stack(out).cpu().numpy()


def train_check(readings: dict, cfg: dict, seed: int, k: int,
                device="cpu") -> dict:
    """The numbers that decide the cell's ``correct``: the checked
    update's first k steps' losses; the worse of the checked update's and
    the one after it (where the run has one) of the first step's gradient
    norm and the change after k steps per leaf (policy, value); the
    forwards of the last
    rollout over the trees that served it and of the next rollout over
    the checked update's trees; the next rollout's actions against their
    uniforms (``action_gap``)."""
    st = _replay(cfg, seed)
    data, plan = inputs(cfg, seed, st)
    nxt = readings.get("next")
    if (nxt is not None) != has_next(st):
        # the program and the reference disagree on where the signal is
        return dict(loss_gap=math.inf, grad_gap=math.inf,
                    change_gap=math.inf, forward_gap=math.inf,
                    action_gap=math.inf)
    U = len(plan) if nxt is not None else k
    follow = readings["first_trees"]
    if nxt is not None:
        follow = nxt["follow"][:U]
    ref = first_steps(data, plan, cfg, U, torch.float64, device,
                      follow=follow)
    ref_k = dict(preds=ref["preds"][:k + 1], losses=ref["losses"][:k])
    out = _gaps(readings["preds"], ref_k, data, plan, cfg, k, device)
    ro = readings["rollout"]
    v, lp = rollout_forwards(ro["codes"], ro["actions"], readings["trees"],
                             cfg, torch.float64, device)
    out["forward_gap"] = max(
        compare.forward_gap(ro["values"], v.cpu().numpy()),
        compare.forward_gap(ro["log_probs"], lp.cpu().numpy()))
    out["action_gap"] = 0.0
    if nxt is None:
        return out
    ens = _heap(ref["trees"], np.zeros(cfg["output_dim"]))
    nd, nplan, ro = next_inputs(cfg, st, ens, torch.float64, device,
                                nxt["actions"])
    nref = first_steps(nd, nplan, cfg, k, torch.float64, device,
                       follow=nxt["follow"][U:U + k])
    P_prog = _walk_prefixes(nd["codes"], nxt["trees"], nxt["base"], k, cfg,
                            device)
    # its losses are left out: at an update's start the clipped surrogate
    # of normalised advantages is 0 up to the rounding of the ratio, so a
    # relative gap of losses there reads the log-probabilities' rounding
    gaps = _gaps(P_prog, nref, nd, nplan, cfg, k, device)
    for name in ("grad_gap", "change_gap"):
        out[name] = max(out[name], gaps[name])
    out["forward_gap"] = max(
        out["forward_gap"], compare.forward_gap(nxt["values"], ro["values"]),
        compare.forward_gap(nxt["log_probs"], ro["log_probs"]))
    out["action_gap"] = ro["action_gap"]
    return out


def serve_outputs(cfg: dict, codes: np.ndarray, ens: dict,
                  dtype=torch.float64, device="cpu"):
    """What a request's call returns: (policy logits [N, A], values [N]),
    over every tree of ``ens`` (heap arrays and bias), for observations
    given as their codes."""
    A = cfg["n_actions"]
    with _no_tf32():
        P = predict(codes, ens, -lr_columns(cfg).numpy(),
                    cfg["tree_struct"]["max_depth"], dtype, device)
    P = P.to(torch.float64).cpu().numpy()
    return P[:, :A], P[:, A]
