"""The serving driver: a deployed agent acts in the configuration's own
vector env, one request per env step, until the deadline.

Set-up makes the served ensemble from the seed on the device (trees of the
configuration's depth and grow policy, ``served_trees`` of them, split at
states the env visits), saves it through the port's checkpoint path and
loads it back, then warms up with ``warmup_requests`` steps of the env.
Each request is the current observations of the configuration's
``n_envs`` envs, the width its example serves at every step; the client
turns the answer into actions (the agent module's ``serve_action``) and
steps the envs outside the request's timer, so every request holds fresh
states of the env's own rollout and the learner's prediction cache never
answers one.  A request is timed from its call to the host holding every
output.  After the window a sample of the requests, drawn from the seed,
is recomputed by the plain reference."""
from __future__ import annotations

import gc
import math
import tempfile
import time

import numpy as np

from .. import envs, hoststats, peaks, tracing
from ..device import free, memory_peak, profiler, sync
from ..work import serve as work


def make_ensemble(cfg: dict, seed: int, pool: np.ndarray,
                  device: str) -> dict:
    """The served ensemble's arrays (host numpy, the port's field names),
    drawn on the device with one generator in a few calls: features
    uniform; each threshold the feature's value in a state drawn from
    ``pool`` (states the env visits); leaf values standard normal; greedy
    trees leave a tenth of their nodes unsplit, oblivious trees share one
    split per level."""
    import torch
    ts = cfg["tree_struct"]
    T = cfg["served_trees"]
    cap = 1 << max(T - 1, 1).bit_length()
    D = ts["max_depth"]
    n_int, L = (1 << D) - 1, 1 << D
    F = cfg["obs_dim"]
    O = cfg["output_dim"]
    states = torch.as_tensor(pool, device=device)
    P = states.shape[0]
    g = torch.Generator(device=device)
    g.manual_seed(seed)
    if ts["grow_policy"] == "oblivious":
        lvl = torch.repeat_interleave(torch.arange(D, device=device),
                                      torch.tensor([1 << d for d in range(D)],
                                                   device=device))
        f_lvl = torch.randint(0, F, (T, D), generator=g, device=device)
        s_lvl = torch.randint(0, P, (T, D), generator=g, device=device)
        feat = f_lvl[:, lvl]
        row = s_lvl[:, lvl]
        split = torch.ones((T, n_int), dtype=torch.bool, device=device)
    else:
        feat = torch.randint(0, F, (T, n_int), generator=g, device=device)
        row = torch.randint(0, P, (T, n_int), generator=g, device=device)
        split = torch.rand((T, n_int), generator=g, device=device) >= 0.1
    thr = states[row, feat]
    leaf = torch.randn((T, L, O), generator=g, device=device)
    feat = torch.where(split, feat, torch.full_like(feat, -1))
    thr = torch.where(split, thr, torch.zeros_like(thr))

    def pad(x, fill):
        tail = torch.full((cap - T,) + tuple(x.shape[1:]), fill,
                          dtype=x.dtype, device=device)
        return torch.cat([x, tail]).cpu().numpy()
    return dict(feat=pad(feat.to(torch.int32), -1),
                thr=pad(thr.to(torch.float32), 0.0),
                cat_code=np.full((cap, n_int), -1, np.int32),
                is_split=pad(split, False),
                is_numeric=np.ones((cap, n_int), bool),
                leaf_values=pad(leaf.to(torch.float32), 0.0),
                counts=np.zeros((cap, 2 * L - 1), np.float32),
                depths=np.where(np.arange(cap) < T, D, 0).astype(np.int32),
                bias=np.zeros(O, np.float32),
                n_trees=np.asarray(T, np.int32))


def run(r) -> dict:
    cfg, mix = r.cfg, r.mix
    E = cfg["n_envs"]
    pool = envs.visited_states(cfg["env"], E, mix["pool_steps"],
                               np.random.default_rng([r.seed, 3]))
    arrays = make_ensemble(cfg, r.seed, pool, r.device)
    with tempfile.TemporaryDirectory() as tmp:
        call = r.agent.serving_model(cfg, arrays, tmp, r.device)
    env = envs.make(cfg["env"], E)
    rng = np.random.default_rng([r.seed, 1])
    obs, _ = env.reset(seed=int(rng.integers(2 ** 31)))
    for _ in range(mix["warmup_requests"]):
        obs = env.step(r.agent.serve_action(cfg, call(obs)))[0]
    sync(r.device)

    spans = prof = None
    if r.trace:
        spans = tracing.Spans()
        prof = profiler(r.device)
        prof.start()
    lat, obs_all, outs = [], [], []
    failed = 0
    host = hoststats.Window()
    t0 = time.perf_counter()
    w0 = time.time_ns()
    deadline = t0 + r.seconds
    while time.perf_counter() < deadline:
        try:
            if spans is None:
                s = time.perf_counter()
                out = call(obs)
                lat.append(time.perf_counter() - s)
            else:
                with spans.span("request", {"rows": E}):
                    s = time.perf_counter()
                    out = call(obs)
                    lat.append(time.perf_counter() - s)
            if not all(np.isfinite(o).all() for o in out):
                failed += 1
        except Exception as e:                # a request that raises fails
            r.log(f"request {len(outs)} raised {e!r}")
            failed += 1
            out = None
        obs_all.append(obs)
        outs.append(out)
        obs = env.step(r.agent.serve_action(cfg, out))[0]
    sync(r.device)
    t1 = time.perf_counter()
    w1 = time.time_ns()
    host.close()
    peak = memory_peak(r.device)
    del call
    r.log(f"{len(outs)} requests of {E} rows in {t1 - t0:.3f} s; "
          f"p50 {1e3 * np.percentile(lat, 50):.4f} ms")
    r.log(f"host {host.report()}")
    out = dict(attempted=len(outs), failed=failed, memory_peak_bytes=peak)
    if r.trace:
        prof.stop()
        T = cfg["served_trees"]
        O = cfg["output_dim"]
        for s in spans.records:
            s["least_s"] = peaks.least_seconds(
                *work.request(cfg, s["ctx"]["rows"], T, O))
        trace = tracing.Trace((w0, w1), spans.records,
                              tracing.device_events(prof))
        del prof
        out.update(metrics=r.per_layer(trace), busy_s=trace.busy_s,
                   window_s=trace.window_s,
                   breakdown=dict(device_ops=trace.top_ops(),
                                  idle_gaps=trace.idle_gaps()))
    else:
        out["metrics"] = {
            "act_p95_ms": {"value": 1e3 * float(np.percentile(lat, 95)),
                           "unit": "ms"},
            "setup_s": {"value": t0 - r.t_start, "unit": "s"}}
    gc.collect()
    free(r.device)
    out["numbers"] = {"output_gap": output_gap(r, arrays, obs_all, outs)}
    out["served"] = dict(arrays=arrays, obs=obs_all, outs=outs)
    return out


def sample_requests(r, n: int) -> list:
    """The requests the check recomputes: a sample of the window's ``n``,
    drawn from the seed (every request has the same rows)."""
    rng = np.random.default_rng([r.seed, 2])
    return sorted(rng.choice(n, size=min(n, r.mix["check_requests"]),
                             replace=False).tolist())


def served_ensemble(r, arrays: dict) -> dict:
    """The served trees' heap arrays and bias, as the reference reads them."""
    T = r.cfg["served_trees"]
    ens = {k: arrays[k][:T] for k in ("feat", "thr", "is_split",
                                      "leaf_values")}
    ens["bias"] = arrays["bias"]
    return ens


def output_gap(r, arrays: dict, obs_all: list, outs: list):
    """The widest gap between the served outputs and the reference's over
    the sampled requests: every output, over the root mean square of the
    reference's; infinite where a sampled request gave no answer."""
    pick = sample_requests(r, len(outs))
    if any(outs[i] is None for i in pick):
        return math.inf
    X = np.concatenate([obs_all[i] for i in pick])
    ref = r.reference.serve_outputs(r.cfg, X, served_ensemble(r, arrays),
                                    device=r.device)
    gaps = []
    for j, want in enumerate(ref):
        got = np.concatenate([np.asarray(outs[i][j], np.float64)
                              .reshape(len(obs_all[i]), -1) for i in pick])
        want = np.asarray(want, np.float64).reshape(len(X), -1)
        scale = max(float(np.sqrt(np.mean(want * want))), 1e-6)
        gaps.append(float(np.max(np.abs(got - want))) / scale)
    return max(gaps)
