"""Plain reference of SAC (soft actor-critic, Haarnoja et al. 2018,
arXiv:1801.01290) with a tanh-Gaussian tree actor and twin parametric-Q
tree critics whose target network is an ensemble prefix (GBRL,
arXiv:2407.08250), for the first gradient steps of a training run.

It replays a run from its seed: the environments; uniform actions in
(-1, 1) before ``learning_starts`` from one numpy generator seeded by the
run's seed, then the actor's tanh-squashed Gaussian sample around its
trees' outputs, with normal draws from a host ``torch.Generator`` seeded
likewise; n-step rows (each row's rewards summed with gamma^i, bootstrap
discount gamma^k, an episode's end flushing its open rows, truncation not
a terminal; the row after an episode's end is the reset's and is left
out); the critics' value jump once ``learning_starts`` steps and a batch
are in the replay (the last parameter column set to r / (1 - disc (1 -
done)) over the replay's means); every ``train_freq`` vector steps
``gradient_steps`` steps, each on ``batch_size`` rows drawn uniformly with
replacement from the same numpy generator.

A gradient step: the target y = R + disc (1 - done) (min_i Q_i(s', a') -
alpha log pi(a'|s')) with a' drawn from the actor over s' and each
critic's trees up to its target prefix (the tree count it last reached at
a multiple of ``target_update_interval``); each critic's tree fit on the
batch's gradient of 0.5 mean (Q - y)^2 with respect to its parameters
(times the batch, each row's weight block and bias block clipped to an L2
norm of ``max_grad_norm``); the actor's tree fit on the gradient of mean
(alpha log pi - min_i Q_i(s, a)) against the UPDATED critics, clipped
likewise; then the temperature's Adam step on -(log alpha)(mean log pi +
target entropy).  Learning rates anneal linearly from ``lin_<lr>`` to
1e-4 over ``schedule_T`` trees; the actor's log-sigma columns take a tenth
of its rate.  The steps' normal draws are inputs: a ``torch.Generator`` on
the run's device seeded with the run's seed's low 31 bits, two [batch, A]
draws a step (next actions, then current ones).

Trees, gradients and losses are computed in ``dtype`` (float64 for the
reference); observations stay float32, as the program's inputs are.
"""
from __future__ import annotations

import functools
import math

import numpy as np
import torch

from .. import compare, envs
from . import trees

STOP_LR = 1e-4
LOG_STD_MIN, LOG_STD_MAX = -20.0, 2.0
CLIP_EPS = 1e-8
ADAM = dict(lr=3e-3, b1=0.9, b2=0.999, eps=1e-8)
TANH_EPS = 1e-6
LOG_2PI = math.log(2.0 * math.pi)


def exact(fn):
    """Run ``fn`` with TF32 off for float32 products on the card (the
    control's precision is its dtype, never TF32's), restoring the
    settings after."""
    @functools.wraps(fn)
    def inner(*args, **kwargs):
        m = torch.backends.cuda.matmul
        c = torch.backends.cudnn
        old = m.allow_tf32, c.allow_tf32
        m.allow_tf32 = c.allow_tf32 = False
        try:
            return fn(*args, **kwargs)
        finally:
            m.allow_tf32, c.allow_tf32 = old
    return inner


def q_dim(cfg: dict) -> int:
    A = cfg["act_dim"]
    return A + (2 if cfg["hyper"]["q_func_type"] == "quadratic" else 1)


def lr_at(lr, T: int, t: int) -> float:
    """The learning rate of tree t: a number, or ``lin_<init>`` annealed
    from init by (t + 1) / T of the way to 1e-4, not below it."""
    if isinstance(lr, str):
        init = float(lr[len("lin_"):])
        return max(STOP_LR, init + (t + 1) / T * (STOP_LR - init))
    return float(lr)


def _scaled(lr, f: float):
    return f"lin_{float(lr[4:]) * f}" if isinstance(lr, str) else lr * f


def column_lrs(cfg: dict, role: str) -> list:
    """Each output column's learning rate (number or ``lin_`` string)."""
    h = cfg["hyper"]
    A = cfg["act_dim"]
    if role == "actor":
        return [h["actor_lr"]] * A + [_scaled(h["actor_lr"], 0.1)] * A
    bias_lr = h.get("bias_lr") or h["critic_lr"]
    return [h["critic_lr"]] * A + [bias_lr] * (q_dim(cfg) - A)


def coefficients(cfg: dict, role: str, n: int) -> np.ndarray:
    """[n, O] coefficients of the first n trees: minus each column's rate."""
    T = cfg["hyper"]["schedule_T"]
    lrs = column_lrs(cfg, role)
    return -np.asarray([[lr_at(lr, T, t) for lr in lrs] for t in range(n)],
                       np.float64).reshape(n, len(lrs))


def prefix(cfg: dict, n: int) -> int:
    k = cfg["hyper"]["target_update_interval"]
    return (n // k) * k


def walk(X, ens: dict, coeff: np.ndarray, depth: int, dtype=torch.float64,
         device="cpu") -> torch.Tensor:
    """bias + the trees of ``ens`` (host heap arrays [T, ...]) times their
    per-tree coefficients [T, O]: [N, O]."""
    X = torch.as_tensor(np.asarray(X, np.float32), device=device)
    bias = torch.as_tensor(np.asarray(ens["bias"], np.float64),
                           device=device).to(dtype)
    T = len(coeff)
    if T == 0:
        return bias[None, :].expand(X.shape[0], -1).clone()
    f = {k: torch.as_tensor(np.asarray(ens[k])[:T], device=device)
         for k in ("feat", "thr", "is_split", "leaf_values")}
    c = torch.as_tensor(coeff, device=device).to(dtype)
    return bias[None, :] + trees.ensemble_sum(
        X, f["feat"], f["thr"], f["is_split"], f["leaf_values"], c, depth,
        dtype)


class Learner:
    """A tree learner: a bias and fitted trees, predicted in ``dtype``."""

    def __init__(self, cfg, role, bias, dtype, device, frozen=False):
        self.cfg, self.role, self.dtype, self.device = cfg, role, dtype, device
        self.bias = np.asarray(bias, np.float64)
        self.fitted = []
        self.depth = cfg["tree_struct"]["max_depth"]
        # the fault "unchanged": trees are fit, none is taken
        self.frozen = frozen

    def arrays(self, n: int = None) -> dict:
        fitted = self.fitted[:n]
        if not fitted:
            O = len(self.bias)
            D = self.depth
            return dict(feat=np.zeros((0, (1 << D) - 1), np.int64),
                        thr=np.zeros((0, (1 << D) - 1), np.float32),
                        is_split=np.zeros((0, (1 << D) - 1), bool),
                        leaf_values=np.zeros((0, 1 << D, O)), bias=self.bias)
        return trees.stack(fitted, self.bias)

    def predict(self, X, stop: int = None) -> torch.Tensor:
        n = len(self.fitted) if stop is None else min(stop, len(self.fitted))
        n = 0 if self.frozen else n
        return walk(X, self.arrays(n), coefficients(self.cfg, self.role, n),
                    self.depth, self.dtype, self.device)


def q_values(w, b, a, qtype: str):
    s = torch.sum(w * a, dim=-1)
    if qtype == "linear":
        return s + b[:, 0]
    if qtype == "quadratic":
        return -((s - b[:, 0]) ** 2) + b[:, 1]
    return b[:, 0] * torch.tanh(s)


def squashed(theta, eps, A: int):
    """(action, log-density) of tanh(mu + sigma eps), log sigma clipped."""
    mu = theta[:, :A]
    log_std = torch.clamp(theta[:, A:], LOG_STD_MIN, LOG_STD_MAX)
    a = torch.tanh(mu + torch.exp(log_std) * eps)
    logp = torch.sum(-0.5 * eps * eps - log_std - 0.5 * LOG_2PI, dim=-1)
    return a, logp - torch.sum(torch.log(1.0 - a * a + TANH_EPS), dim=-1)


def clip_blocks(g, A: int, max_norm: float):
    if not max_norm:
        return g
    out = []
    for blk in (g[:, :A], g[:, A:]):
        n = torch.sqrt(torch.sum(blk * blk, dim=-1, keepdim=True))
        out.append(blk * torch.clamp(max_norm / (n + CLIP_EPS), max=1.0))
    return torch.cat(out, dim=1)


def _fit(cfg: dict, X, g, dtype, device, fault: str = "",
         follow: dict = None) -> dict:
    ts = cfg["tree_struct"]
    N = X.shape[0]
    w = torch.ones(N, dtype=dtype, device=device)
    if fault == "half_batch":
        w = w * (torch.arange(N, device=device) < N // 2)
    fw = torch.as_tensor(cfg["feature_weights"], device=device).to(dtype)
    return trees.fit_tree(X, g.detach(), w, fw, ts["max_depth"],
                          ts["n_bins"], cfg["params"]["split_score_func"],
                          ts["grow_policy"] == "oblivious", dtype, follow)


@exact
def gradient_step(cfg: dict, actor: Learner, critics: list, prefixes: list,
                  batch: dict, eps_next, eps_cur, alpha: float, u: int = 0,
                  fault: str = "", follow: dict = None) -> dict:
    """One gradient step: each critic, then the actor, takes its new tree
    (in place).  ``batch``: obs and nobs (float32 numpy), act, rew, done
    and disc (tensors); ``u`` the step's index into ``follow``.  Returns
    the critics' and the actor's losses, each critic's target sums over
    the next observations, the clipped gradients (times the batch) and
    the new trees of each learner ("critic<i>", "actor"), and the mean
    log-density of the current actions."""
    h = cfg["hyper"]
    A = cfg["act_dim"]
    dt, dev = actor.dtype, actor.device
    qtype = h["q_func_type"]
    obs, nobs = batch["obs"], batch["nobs"]
    N = len(obs)
    X = torch.as_tensor(obs, device=dev)

    def fit(role, g):
        f = follow[role][u] if follow and u < len(follow[role]) else None
        return _fit(cfg, X, g, dt, dev, fault, f)

    # target over the next observations, each critic to its prefix
    na, nlogp = squashed(actor.predict(nobs), eps_next.to(dt), A)
    stops = [None if fault == "whole_target" else p for p in prefixes]
    tsums = [c.predict(nobs, stop) for c, stop in zip(critics, stops)]
    qt = torch.stack([q_values(t[:, :A], t[:, A:], na, qtype) for t in tsums])
    y = batch["rew"] + batch["disc"] * (1.0 - batch["done"]) * (
        torch.amin(qt, 0) - alpha * nlogp)

    losses, grads, new = [], {}, {}
    for i, c in enumerate(critics):
        theta = c.predict(obs).detach().requires_grad_(True)
        with torch.enable_grad():
            q = q_values(theta[:, :A], theta[:, A:], batch["act"], qtype)
            loss = 0.5 * torch.mean((q - y) ** 2)
            (g,) = torch.autograd.grad(loss, theta)
        role = f"critic{i}"
        grads[role] = clip_blocks(g * N, A, h["max_grad_norm"])
        new[role] = fit(role, grads[role])
        c.fitted.append(new[role])
        losses.append(loss.detach())

    # the actor against the UPDATED critics
    theta = actor.predict(obs).detach().requires_grad_(True)
    qth = [c.predict(obs) for c in critics]
    with torch.enable_grad():
        a, logp = squashed(theta, eps_cur.to(dt), A)
        qs = torch.stack([q_values(t[:, :A], t[:, A:], a, qtype)
                          for t in qth])
        aloss = torch.mean(alpha * logp - torch.amin(qs, 0))
        (ga,) = torch.autograd.grad(aloss, theta)
    grads["actor"] = clip_blocks(ga * N, A, h["max_grad_norm"])
    new["actor"] = fit("actor", grads["actor"])
    actor.fitted.append(new["actor"])
    losses.append(aloss.detach())
    return dict(losses=torch.stack(losses).to(torch.float64).cpu().numpy(),
                targets=[t.to(torch.float64).cpu().numpy() for t in tsums],
                grads=grads, trees=new,
                logp_mean=float(torch.mean(logp.detach())))


class Run:
    """A SAC run replayed from its seed through its first gradient steps.

    ``fault`` plants a fault to be measured: "half_batch" (half of each
    batch's rows weigh nothing in the fits), "unchanged" (no learner takes
    its trees), "whole_target" (targets over every critic tree instead of
    the prefix); ``follow`` (the program's first trees per learner) settles
    the split rule's ties, as in reference/ppo.py."""

    def __init__(self, cfg: dict, seed: int, dtype=torch.float64,
                 device="cpu", fault: str = "", follow: dict = None):
        self.cfg, self.seed, self.dtype, self.device = cfg, seed, dtype, device
        self.fault, self.follow = fault, follow
        h = cfg["hyper"]
        A = cfg["act_dim"]
        self.A = A
        critic_bias = np.zeros(q_dim(cfg))
        critic_bias[:A] = 1.0
        frozen = fault == "unchanged"
        self.critics = [Learner(cfg, "critic", critic_bias, dtype, device,
                                frozen) for _ in range(h["n_critics"])]
        self.actor = Learner(cfg, "actor", [0.0] * A
                             + [h["log_std_init"]] * A, dtype, device, frozen)
        self.prefixes = [0] * h["n_critics"]
        ent = h["ent_coef"]
        # "auto" starts the temperature at 0.1, "auto_<init>" at init
        init = ((float(ent.split("_")[1]) if "_" in ent else 0.1)
                if isinstance(ent, str) else float(ent))
        self.log_alpha = float(np.float32(np.log(init)))
        self.adam = dict(m=0.0, v=0.0, t=0)
        self.rng = np.random.default_rng(seed)
        self.gen = torch.Generator().manual_seed(seed)
        self.noise = torch.Generator(device=device)
        self.noise.manual_seed(seed & 0x7FFFFFFF)
        self.rows = dict(obs=[], act=[], rew=[], nobs=[], done=[], disc=[])
        self.steps_done = []

    # --------------------------------------------------------------- replay
    def _act(self, obs: np.ndarray) -> np.ndarray:
        eps = torch.randn((len(obs), self.A), generator=self.gen)
        theta = self.actor.predict(obs).to(torch.float64).cpu()
        a, _ = squashed(theta, eps.to(torch.float64), self.A)
        return a.numpy().astype(np.float32)

    def _emit(self, win: list, next_obs, done: float) -> None:
        g = self.cfg["hyper"]["gamma"]
        o, a, rs = win
        self.rows["obs"].append(o)
        self.rows["act"].append(a)
        self.rows["rew"].append(sum(g ** i * r for i, r in enumerate(rs)))
        self.rows["nobs"].append(next_obs)
        self.rows["done"].append(done)
        self.rows["disc"].append(g ** len(rs))

    def replay(self, k: int) -> "Run":
        """Step the envs, fill the replay and take the first k gradient
        steps."""
        cfg, h = self.cfg, self.cfg["hyper"]
        E, n = cfg["n_envs"], h["n_step"]
        env = envs.make(cfg["env"], E)
        obs, _ = env.reset(seed=self.seed)
        windows = [[] for _ in range(E)]
        after_end = np.zeros(E, bool)
        steps = it = 0
        bias_set = False
        while len(self.steps_done) < k and steps < cfg["total_timesteps"]:
            if steps < h["learning_starts"]:
                a = self.rng.uniform(-1.0, 1.0, (E, self.A)).astype(np.float32)
            else:
                a = self._act(obs)
            nobs, r, term, trunc, _ = env.step(a * np.float32(
                cfg["max_action"]))
            for i in range(E):
                if after_end[i]:
                    continue
                windows[i].append([obs[i], a[i], []])
                for w in windows[i]:
                    w[2].append(float(r[i]))
                if term[i] or trunc[i]:
                    for w in windows[i]:
                        self._emit(w, nobs[i], 1.0 if term[i] else 0.0)
                    windows[i] = []
                elif len(windows[i][0][2]) == n:
                    self._emit(windows[i].pop(0), nobs[i], 0.0)
            after_end = np.logical_or(term, trunc)
            obs = nobs
            steps += E
            it += 1
            held = len(self.rows["rew"])
            if (steps >= h["learning_starts"] and not bias_set
                    and held >= h["batch_size"]):
                self._value_jump()
                bias_set = True
            if (steps >= h["learning_starts"] and it % h["train_freq"] == 0
                    and held >= h["batch_size"]):
                for _ in range(h["gradient_steps"]):
                    if len(self.steps_done) < k:
                        self.gradient_step(self.rng.integers(
                            0, held, h["batch_size"]))
        return self

    def _value_jump(self) -> None:
        r = np.mean(self.rows["rew"])
        d = np.mean(self.rows["done"])
        g = np.mean(self.rows["disc"])
        v0 = r / max(1.0 - g * (1.0 - d), 1e-3)
        for c in self.critics:
            c.bias = c.bias.copy()
            c.bias[-1] = v0

    # -------------------------------------------------------- gradient step
    def gradient_step(self, idx: np.ndarray) -> None:
        h, A, dt, dev = self.cfg["hyper"], self.A, self.dtype, self.device
        R = self.rows

        def col(name):
            return torch.as_tensor(np.asarray([R[name][i] for i in idx],
                                              np.float64), device=dev).to(dt)
        batch = dict(obs=np.stack([R["obs"][i] for i in idx]),
                     nobs=np.stack([R["nobs"][i] for i in idx]),
                     act=torch.as_tensor(np.stack([R["act"][i] for i in idx]),
                                         device=dev).to(dt),
                     rew=col("rew"), done=col("done"), disc=col("disc"))
        N = len(idx)
        eps_next = torch.randn((N, A), generator=self.noise, device=dev)
        eps_cur = torch.randn((N, A), generator=self.noise, device=dev)
        alpha = math.exp(self.log_alpha)
        out = gradient_step(self.cfg, self.actor, self.critics,
                            self.prefixes, batch, eps_next, eps_cur, alpha,
                            len(self.steps_done), self.fault, self.follow)
        self._temperature(out["logp_mean"])
        for i, c in enumerate(self.critics):
            if len(c.fitted) % h["target_update_interval"] == 0:
                self.prefixes[i] = len(c.fitted)
        self.steps_done.append(dict(
            batch, eps_next=eps_next.to(dt), eps_cur=eps_cur.to(dt),
            alpha=alpha, losses=out["losses"], targets=out["targets"]))

    def _temperature(self, logp_mean: float) -> None:
        """Adam on -(log alpha)(mean log pi + target entropy)."""
        if not isinstance(self.cfg["hyper"]["ent_coef"], str):
            return
        g = -(logp_mean + self.cfg["hyper"]["target_entropy"])
        s = self.adam
        s["t"] += 1
        s["m"] = ADAM["b1"] * s["m"] + (1 - ADAM["b1"]) * g
        s["v"] = ADAM["b2"] * s["v"] + (1 - ADAM["b2"]) * g * g
        m_hat = s["m"] / (1 - ADAM["b1"] ** s["t"])
        v_hat = s["v"] / (1 - ADAM["b2"] ** s["t"])
        self.log_alpha -= ADAM["lr"] * m_hat / (math.sqrt(v_hat) + ADAM["eps"])

    # ------------------------------------------------------------- readings
    def learners(self) -> dict:
        return dict([(f"critic{i}", c) for i, c in enumerate(self.critics)]
                    + [("actor", self.actor)])

    def checked_rows(self) -> np.ndarray:
        """Each checked step's observations, then its next observations."""
        return np.concatenate([x for s in self.steps_done
                               for x in (s["obs"], s["nobs"])])


def _run(cfg, seed, k, dtype=torch.float64, device="cpu", fault="",
         follow=None) -> Run:
    return Run(cfg, seed, dtype, device, fault, follow).replay(k)


@exact
def inputs(cfg: dict, seed: int):
    """The checked steps of a run with this seed: (data, the run) where
    data["obs"] are the rows the check reads the learners over."""
    run = _run(cfg, seed, 3)
    return dict(obs=run.checked_rows()), run


def _preds(run: Run, X1, k: int) -> dict:
    """Each learner's predictions over X1 at 0..k trees [k + 1, n, O]."""
    return {role: np.stack([ln.predict(X1, t).to(torch.float64).cpu()
                            .numpy() for t in range(k + 1)])
            for role, ln in run.learners().items()}


@exact
def stand_in(cfg: dict, seed: int, k: int, dtype=torch.float64,
             device="cpu", fault: str = "") -> dict:
    """The reference in the program's place, in the readings' format of
    agents/sac.py ``readings``: for the control (a lower ``dtype``) and the
    planted faults.  Its rollout is the first checked rows, acted on by its
    own actor trees with draws of its own; its later step's target sums
    are its critics' over the checked rows, up to the prefix (or,
    "whole_target", over every tree)."""
    run = _run(cfg, seed, k, dtype, device, fault)
    X1 = inputs(cfg, seed)[0]["obs"]
    out = _preds(run, X1, k)
    out["first_trees"] = {role: trees.unstack(ln.fitted)
                          for role, ln in run.learners().items()}
    h = cfg["hyper"]
    n = cfg["n_envs"] * h["train_freq"]
    eps = torch.randn((n, cfg["act_dim"]),
                      generator=torch.Generator().manual_seed(seed))
    D = cfg["tree_struct"]["max_depth"]
    ens = run.actor.arrays()
    theta = walk(X1[:n], ens, coefficients(cfg, "actor", len(ens["feat"])),
                 D, dtype, device).to(torch.float64).cpu()
    a, _ = squashed(theta, eps.to(torch.float64), cfg["act_dim"])
    out["rollout"] = dict(obs=X1[:n], actions=a.numpy(), eps=eps.numpy())
    out["trees"] = ens
    sums, held = [], []
    for c in run.critics:
        ens = c.arrays()
        stop = len(c.fitted) if fault == "whole_target" else prefix(
            cfg, len(c.fitted))
        sums.append(walk(X1, ens, coefficients(cfg, "critic", stop), D,
                         dtype, device).to(torch.float64).cpu().numpy())
        held.append(ens)
    out["target"] = dict(obs=X1, sums=sums, trees=held)
    return out


def _losses(cfg: dict, run: Run, P: dict, k: int, device) -> list:
    """Each checked step's critic and actor losses, with the program's
    predictions ``P`` (over the checked rows, at 0..k trees) in place of
    the learners' and the reference's data, draws and temperature."""
    h = cfg["hyper"]
    A = cfg["act_dim"]
    qtype = h["q_func_type"]
    N = h["batch_size"]
    C = h["n_critics"]
    out = []
    for u, s in enumerate(run.steps_done[:k]):
        o = slice(2 * u * N, 2 * u * N + N)
        nx = slice(2 * u * N + N, 2 * (u + 1) * N)

        def at(role, t, rows):
            return torch.as_tensor(P[role][t][rows], device=device)
        na, nlogp = squashed(at("actor", u, nx), s["eps_next"].to(
            torch.float64), A)
        qt = torch.stack([q_values(t[:, :A], t[:, A:], na, qtype) for t in
                          (at(f"critic{i}", prefix(cfg, u), nx)
                           for i in range(C))])
        y = s["rew"].to(torch.float64) + s["disc"].to(torch.float64) * (
            1.0 - s["done"].to(torch.float64)) * (
            torch.amin(qt, 0) - s["alpha"] * nlogp)
        act = s["act"].to(torch.float64)
        for i in range(C):
            th_c = at(f"critic{i}", u, o)
            q = q_values(th_c[:, :A], th_c[:, A:], act, qtype)
            out.append(float(0.5 * torch.mean((q - y) ** 2)))
        a, logp = squashed(at("actor", u, o), s["eps_cur"].to(
            torch.float64), A)
        qs = torch.stack([q_values(t[:, :A], t[:, A:], a, qtype) for t in
                          (at(f"critic{i}", u + 1, o) for i in range(C))])
        out.append(float(torch.mean(s["alpha"] * logp - torch.amin(qs, 0))))
    return out


def _leaves(cfg: dict) -> dict:
    """(learner, columns) of each leaf: a block of columns with one
    optimizer."""
    A = cfg["act_dim"]
    Q = q_dim(cfg)
    out = {}
    for i in range(cfg["hyper"]["n_critics"]):
        out[f"critic{i}.weights"] = (f"critic{i}", list(range(A)))
        out[f"critic{i}.bias"] = (f"critic{i}", list(range(A, Q)))
    out["actor.mu"] = ("actor", list(range(A)))
    out["actor.log_std"] = ("actor", list(range(A, 2 * A)))
    return out


def _gap_norms(cfg: dict, P: dict, k: int) -> tuple:
    """({leaf: first tree's norm over the first batch / its rate},
    {leaf: norm of the change after k trees over every checked row})."""
    N = cfg["hyper"]["batch_size"]
    T = cfg["hyper"]["schedule_T"]
    g, c = {}, {}
    for leaf, (role, cols) in _leaves(cfg).items():
        lr = lr_at(column_lrs(cfg, "actor" if role == "actor" else "critic")
                   [cols[0]], T, 0)
        d1 = (P[role][1] - P[role][0])[:N][:, cols]
        g[leaf] = float(np.linalg.norm(d1)) / lr
        c[leaf] = float(np.linalg.norm((P[role][k] - P[role][0])[:, cols]))
    return g, c


@exact
def train_check(readings: dict, cfg: dict, seed: int, k: int,
                device="cpu") -> dict:
    """The numbers that decide a training cell's ``correct``: the first k
    steps' critic and actor losses, the first tree's norm and the change
    after k trees per leaf, the last rollout's actions from the actor trees
    that served it, and the target-prefix sums: at each checked step (the
    prefix is 0 there, so these hold the critics' biases after the value
    jump), and at the step the program took after the unit's end, whose
    prefix has moved, against a walk of the trees each critic held."""
    h = cfg["hyper"]
    A = cfg["act_dim"]
    D = cfg["tree_struct"]["max_depth"]
    run = _run(cfg, seed, k, torch.float64, device,
               follow=readings["first_trees"])
    # the rows the readings were taken over: where a tie in the first
    # trees settles as the program's, the actions after the first train
    # event, and so a few next observations of a later step, move by a
    # rounding from those of the run without the program's trees
    X1 = inputs(cfg, seed)[0]["obs"]
    ref = _preds(run, X1, k)
    prog = {role: np.asarray(readings[role], np.float64) for role in ref}
    prog_losses = _losses(cfg, run, prog, k, device)
    ref_losses = np.concatenate([s["losses"] for s in run.steps_done])
    g_ref, c_ref = _gap_norms(cfg, ref, k)
    g_prog, c_prog = _gap_norms(cfg, prog, k)
    kept = compare.kept_leaves(g_ref)

    ro = readings["rollout"]
    eps = ro.get("eps")
    n = len(ro["obs"])
    if eps is None:
        E = cfg["n_envs"]
        served = ro["steps"] // E - -(-h["learning_starts"] // E)
        gen = torch.Generator().manual_seed(seed)
        for _ in range(served - n // E):
            torch.randn((E, A), generator=gen)
        eps = torch.cat([torch.randn((E, A), generator=gen)
                         for _ in range(n // E)]).numpy()
    ens = readings["trees"]
    theta = walk(ro["obs"], ens, coefficients(cfg, "actor", len(
        ens["feat"])), D, torch.float64, device).cpu()
    a, _ = squashed(theta, torch.as_tensor(eps, dtype=torch.float64), A)

    N = h["batch_size"]
    t_prog, t_ref = [], []
    for u, s in enumerate(run.steps_done[:k]):
        nx = slice(2 * u * N + N, 2 * (u + 1) * N)
        for i, ts in enumerate(s["targets"]):
            t_prog.append(prog[f"critic{i}"][prefix(cfg, u)][nx])
            t_ref.append(ts)
    # a later step's: each critic's sums up to the prefix of the trees it
    # held, over that step's next observations
    tg = readings["target"]
    if len(tg["sums"]) != h["n_critics"]:
        t_prog.append(math.inf)
        t_ref.append(1.0)
    for sums, ens_c in zip(tg["sums"], tg["trees"]):
        p = prefix(cfg, len(ens_c["feat"]))
        t_prog.append(np.asarray(sums, np.float64))
        t_ref.append(walk(tg["obs"], ens_c, coefficients(cfg, "critic", p),
                          D, torch.float64, device).cpu().numpy())
    return dict(loss_gap=compare.loss_gap(prog_losses, ref_losses),
                grad_gap=compare.norm_gap(g_prog, g_ref, kept),
                change_gap=compare.norm_gap(c_prog, c_ref, kept),
                forward_gap=compare.forward_gap(ro["actions"], a.numpy()),
                target_gap=max(compare.forward_gap(p_, r_) for p_, r_ in
                               zip(t_prog, t_ref)))


@exact
def serve_outputs(cfg: dict, obs: np.ndarray, ens: dict,
                  dtype=torch.float64, device="cpu"):
    """What a served actor returns: (tanh of the mean, log sigma) [N, A]
    each, over every tree of ``ens`` (heap arrays and bias)."""
    A = cfg["act_dim"]
    theta = walk(obs, ens, coefficients(cfg, "actor", len(ens["feat"])),
                 cfg["tree_struct"]["max_depth"], dtype, device)
    theta = theta.to(torch.float64).cpu().numpy()
    return np.tanh(theta[:, :A]), theta[:, A:]
