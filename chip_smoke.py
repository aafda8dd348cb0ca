#!/usr/bin/env python3
"""Drive gbrl_tpu_torch's serving and training paths on one NVIDIA GPU and
check them.

    python3 chip_smoke.py [--seed 0]

Full width is the PPO shared actor-critic shape (bench.py:48-58): F = 16
numeric features, O = 3 outputs (2 policy + 1 value), depth 4, batches of
N = 4096 observations; serving reads 1600 trees in a capacity of 2048;
training fits with 256 quantile bins (257 buckets) and the cosine score,
greedy and oblivious.  Ensembles, observations and gradients are
synthetic, made with numpy from ``--seed``.  The kernels are the CUDA C++
ones in ``gbrl_tpu_torch/csrc``: K1 bucketize, K2 level histogram and K3
level split score (``fit.cu``); K4 greedy and K5 oblivious leaf sums
(``predict.cu``); K6 whole tree (``tree.cu``).  SHAP and the utils
(phase 15) add no kernel: their ensembles are grown through K1-K3 and held
against predictions through K4 / K5.

Phases (any failure raises; the script then exits nonzero):
  1 device   the card's name, power limit and CUDA version;
  2 build    nvcc builds the kernels from the sources in the checkout;
  3 parity   K4 and K5 against their plain PyTorch versions at full width
             (ties x == thr, NaN rows, pass-through nodes, stale weights
             beyond n_trees), the coefficients given apart (the same bits
             as pre-scaled weights, and on two launches), K5 bit-equal to
             K4 on oblivious ensembles, the edge cases N = 1000, n_trees in
             {0, 1, 129}, and ``ops.predict.weighted_leaf_sum`` on wide
             (F = 300), deep (depth 8, 11, 12) and wide-output (O = 11)
             numeric ensembles, which must reach the kernels once each;
  4 serving  greedy, oblivious and Adam checkpoints saved by the port,
             loaded on the card, requests answered and held against the
             same checkpoint loaded on the CPU; launch counts set to 0
             before and read after: K4 and K5 must have run;
  5 times    request latency (host clock, synchronized); K4 and K5 at the
             serving shape, the PPO rollout predict (N = 4096, 160 of 1024
             trees, F = 4) and A2C's cv_momentum (N = 1024, 20 oblivious
             trees): call time (CUDA events), host time (enqueue) and
             device time per call (torch.profiler; one device kernel per
             call asserted) beside the plain versions and the bound;
  6 fit parity  K1 bit-equal to its plain version (ties, duplicate
             candidates, NaN rows); K2 within RTOL / ATOL of its plain
             version at C = 4, 8, 16, 32 and the same bits on two launches;
             K3's chosen indices equal to its plain version's and its
             values within 1e-6 (greedy/oblivious x cosine/l2 x min_data,
             a zero feature weight); K3 at O = 256 (rows in global
             scratch) likewise; build_tree at F = 300 / depth 4 and
             F = 16 / depth 6 reaches K2 / K3;
  7 training launch counts set to 0, then: a shared ActorCritic on the card,
             greedy and then oblivious, takes 50 steps (K1 = 50, K2 = K3 =
             200 each), every tree held against the CPU port's on the same
             inputs (equal, or a near tie that is printed), the trained
             ensemble's predictions (K4 / K5) against the CPU; distil; a
             separate ActorCritic; GBTLearner.fit, 200 iterations, loss
             within 1e-4 of the CPU port's; counts read after;
  8 fit times  ActorCritic.step latency (p50 / p90 over 50 steps) given
             host arrays, and given the card gradients a backward pass left
             on the predicted leaves; fit trees per second; host
             synchronisations in one boosting step and in both kinds of
             step; K1, K2 and K3 at the bench and the PPO minibatch shape
             (N = 512, F = 4): held against their plain versions, then the
             call time (one call between CUDA events), the host time
             (enqueue) and the device time per call (torch.profiler), which
             must be one device launch, beside torch.searchsorted's /
             index_add_'s, measured the same ways, their bounds and plain
             versions;
  9 tree parity  K6 against its plain version, the K6 path's trees against
             the level path's;
  10-11 RL   PPO and A2C on CartPole on both tree paths, one update phase
             held against the CPU port with its launch counts; PPO's
             phase as CUDA graph replays bit-equal to its steps run as
             plain calls on the card, with the same launch counts and a
             replay (or the one warm-up, captured minibatch of a new
             shape) a tree;
  12 RL times  update-phase latency on both paths, syncs, rollout rate,
             profiles; K6's call, host and kernel times at the PPO minibatch
             and the bench shape (one device launch per call).
  13 AWR     on ``VecPendulum`` at examples/awr_vs_ref.py's width (8 envs,
             rollouts of 2048, 60 critic + 20 actor trees on minibatches of
             2048, depth 4, 256 bins, oblivious): AWR.learn on both tree
             paths, with its graph captures and replays; one
             run_awr_update from one state on the card (both paths), its
             plain calls held against the CPU port tree for tree, launches
             asserted (K1 = K5 = 80; K2 = K3 = 320 or K6 = 80; K4 = 0), and
             as CUDA graph replays (a replay a tree, one capture a learner
             and key) bit-equal to the plain calls twice, with their
             launches; the update phase's p50 / p90, trees/s, host syncs
             (0 inside awr_update_loop, asserted), device busy share; K1-K3
             and K5 at the update's shapes (N = 2048, F = 3, O = 1);
  14 SAC     at examples/sac_pendulum.py's defaults (linear Q, twin
             critics, 10-step targets, batch 256): SAC.learn, launches
             asserted per train step (K1 = 3, K2 = K3 = 12, K5 = 8); one
             sac_train_step from one state per Q-form, the same noise, on the
             card and the CPU port, tree for tree; the train step's p50 /
             p90 and host syncs (1, the stats fetch, asserted); K1-K3 and K5
             at the step's shapes (N = 256, F = 3, O = 2), K5 at the target's
             prefix stop also held against the prefix alone.
  15 explain/export  SHAP and the utils on ensembles grown on the card: a
             shared ActorCritic per policy takes 400 steps (K1 = 400,
             K2 = K3 = 1600 asserted), its twin is the same checkpoint on the
             CPU port; ``shap`` over 4096 rows against the twin (first 512
             rows), the host recursion (8 rows; ``tree_shap`` for 3 trees
             too) and local accuracy (sum_f phi + E_raw against the raw leaf
             sum through K4 / K5); ``ref_compat`` bit-equal to the twin;
             shap p50 / p90, host syncs (equal at 200 and 400 trees), peak
             memory, busy share; the float C header built with
             ``CompiledModel`` against the card's predict; ``print_tree`` /
             ``plot_tree``; the reference format written and loaded on the
             card (predictions and SHAP); a mixed GBTModel (2 numeric, 4
             categorical columns) against its twin; one ``shap`` call
             under ``profiling.trace`` naming CUDA kernels and the
             ``annotate`` span.
  16 parallel  data-parallel training over torch.distributed: (a) two gloo
             ranks (subprocesses of this script, CUDA tensors) share the
             card and train one PPO actor-critic at
             examples/multihost_ppo.py's width (per rank 8 ``VecCartPole``
             envs x 128 steps served by a host mirror, GAE on the local
             slice, a global plan from a shared seed,
             ``hosts.host_ppo_update`` with minibatches of 256 and 4
             epochs: 32 trees a phase; depth 4, 64 bins), 3 iterations per
             tree path: both ranks' ensembles bit-identical after every
             iteration, each iteration's trees against one process running
             ``ppo_update_loop`` on the card over both rollouts, launches
             per rank and phase asserted (K1 = 32, K2 = K3 = 128 or
             K6 = 32, K4 = 1), phase p50 / p90 per rank beside the single
             process, syncs, collectives, a profiled phase; (b) the
             supervised steps at the bench shape over the two ranks (20
             ``host_train_step`` + 2 ``host_boost_step`` per grow policy,
             K1 = 1, K2 = K3 = 4 a step asserted) against one process's
             ``boost_step`` sequence on the card, K6 with sharded samples
             raising; (c) the same steps through an NCCL group of one,
             bit-equal to the single-process card path, 0 host syncs a
             step.
  17 api     the public names the port added last: a shared and a separate
             ActorCritic per grow policy at full width (200 trees), written
             by the CPU port and loaded on the card: ``get_num_trees``,
             requests, ``SeparateActorCriticLearner.predict``,
             ``save_learner`` from the card loaded back on the CPU,
             ``chunk_leaf_indices`` and ``tree_shap_device_one`` against the
             CPU; every request on fresh rows, K4 and K5 launched once
             per learner a request reaches (11 each), no fit kernel.

Without a CUDA device it exits nonzero before printing any result.  It
prints, before the last line, the nvidia-smi name/power-limit line and one
JSON line describing each kernel; the last line is the ok/device JSON.
"""
import argparse
import contextlib
import json
import math
import os
import subprocess
import sys
import tempfile
import time

import numpy as np

N, F, O, DEPTH = 4096, 16, 3, 4
CAPACITY, N_TREES = 2048, 1600
# parity tolerance: |kernel - plain| <= RTOL * max|plain| + ATOL (the two sum
# 1600 f32 terms in different orders)
RTOL, ATOL = 1e-5, 1e-6
KERNEL_REPS = 30       # CUDA-event timed launches per kernel
REQUESTS = 100         # timed requests per latency figure (p90: 10 beyond)
# H100 SXM peaks (NVIDIA data sheet): HBM bytes/s and f32 non-tensor flop/s.
# The flop rate counts an FMA as 2; a compare or an add takes the same issue
# slot as an FMA, so bound_ms counts each as 2.
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12
FLOPS_PER_INSTR = 2
# wide, deep and wide-output numeric shapes (F, depth, O) that ops.predict
# must send to the kernels: the TPU's VMEM guard (at most 256 features,
# depth 6) is not theirs, and depth 11 / 12 lie past the shared-memory
# budget (the global route); O = 11 is one launch
DISPATCH_SHAPES = ((300, 4, 3), (16, 8, 3), (16, 11, 3), (16, 12, 3),
                   (16, 4, 11))
DISPATCH_CAPACITY, DISPATCH_TREES = 512, 400
# K4 / K5 timed at the serving shape (above) and at the RL shapes: the PPO
# rollout predict (rl/ppo.py:279; 4096 CartPole rows, the five phases' 160
# greedy trees in the default capacity of 1024) and A2C's cv_momentum
# (1024 rows, 20 oblivious trees): (label, kernel, policy, N, F, T_cap,
# n_trees)
PREDICT_TIMES = (("ppo_rollout", "weighted_leaf_sum", "greedy", 4096, 4,
                  1024, 160),
                 ("a2c_cv", "oblivious_leaf_sum", "oblivious", 1024, 4,
                  1024, 20))
WIDE_SCORE_O = 256      # K3 past its shared-memory budget (phase 6)
REPLACES = {"weighted_leaf_sum": "gbrl_tpu/ops/pallas_kernels.py:723",
            "oblivious_leaf_sum": "gbrl_tpu/ops/pallas_kernels.py:851",
            "bucketize": "gbrl_tpu/ops/pallas_kernels.py:46",
            "level_histogram": "gbrl_tpu/ops/pallas_kernels.py:97",
            "level_score": "gbrl_tpu/ops/pallas_kernels.py:215",
            "tree_build": "gbrl_tpu/ops/pallas_kernels.py:359"}
PREDICT_KERNELS = ("weighted_leaf_sum", "oblivious_leaf_sum")
# the fit path at full width (bench.py:48-58): quantile candidates, 256 bins
# (257 buckets), cosine score
N_BINS = 256
TRAIN_STEPS = 50        # ActorCritic.step calls per grow policy (phase 7)
SEPARATE_STEPS = 10     # separate-mode steps held against the CPU
FIT_ITERS = 200         # GBTLearner.fit iterations (phases 7 and 8)
DISTIL_ITERS = 50
FIT_LOSS_RTOL = 1e-4    # card vs CPU port: fit and distil losses
# a tree that differs between the card and the CPU is allowed only where the
# two chosen candidates' scores lie within this relative distance (the
# histograms are summed in another order, so scores differ in the last ulps)
TIE_RTOL = 1e-5
STEP_WARMUP = 5
# wide and deep numeric trees that build_tree must send to K2 / K3
WIDE_TREES = ((300, 4), (16, 6))


class VecCartPole:
    """CartPole-v1 for ``n`` envs in numpy, with the interface PPO and A2C
    read from a gymnasium vector env (``num_envs``,
    ``single_observation_space.shape``, ``single_action_space.n``, ``reset``,
    ``step``): the card's machine has no gymnasium.  The equations, constants
    and Euler step of gymnasium's ``envs/classic_control/cartpole.py`` on a
    float64 state; termination at |x| > 2.4 or |theta| > 12 degrees; reward 1
    on every stepped row; truncation after 500 steps (the TimeLimit of
    CartPole-v1); and the next-step autoreset of gymnasium's vector envs: a
    row that ended is reset on the following step, which returns the reset
    observation, reward 0 and neither flag (``RolloutBuffer.flat`` masks such
    rows).  Resets draw from U(-0.05, 0.05) with a numpy generator seeded by
    ``reset(seed)``."""
    GRAVITY, MASSCART, MASSPOLE, LENGTH = 9.8, 1.0, 0.1, 0.5
    FORCE_MAG, TAU, X_LIMIT, MAX_STEPS = 10.0, 0.02, 2.4, 500
    THETA_LIMIT = 12 * 2 * math.pi / 360

    def __init__(self, n: int):
        from types import SimpleNamespace
        self.num_envs = n
        self.single_observation_space = SimpleNamespace(shape=(4,))
        self.single_action_space = SimpleNamespace(n=2)
        self.rng = np.random.default_rng()
        self.state = np.zeros((n, 4))
        self.steps = np.zeros(n, np.int64)
        self.autoreset = np.zeros(n, bool)

    def reset(self, seed=None):
        self.rng = np.random.default_rng(seed)
        self.state = self.rng.uniform(-0.05, 0.05, (self.num_envs, 4))
        self.steps[:] = 0
        self.autoreset[:] = False
        return self.state.astype(np.float32), {}

    def step(self, actions):
        total_mass = self.MASSPOLE + self.MASSCART
        polemass_length = self.MASSPOLE * self.LENGTH
        x, x_dot, theta, theta_dot = (self.state[:, i].copy()
                                      for i in range(4))
        force = np.where(np.asarray(actions) == 1, self.FORCE_MAG,
                         -self.FORCE_MAG)
        costheta, sintheta = np.cos(theta), np.sin(theta)
        temp = (force + polemass_length * np.square(theta_dot) * sintheta
                ) / total_mass
        thetaacc = (self.GRAVITY * sintheta - costheta * temp) / (
            self.LENGTH * (4.0 / 3.0 - self.MASSPOLE * np.square(costheta)
                           / total_mass))
        xacc = temp - polemass_length * thetaacc * costheta / total_mass
        x = x + self.TAU * x_dot
        x_dot = x_dot + self.TAU * xacc
        theta = theta + self.TAU * theta_dot
        theta_dot = theta_dot + self.TAU * thetaacc
        stepped = np.stack([x, x_dot, theta, theta_dot], axis=1)
        terms = ((x < -self.X_LIMIT) | (x > self.X_LIMIT)
                 | (theta < -self.THETA_LIMIT) | (theta > self.THETA_LIMIT))
        self.steps += 1
        truncs = self.steps >= self.MAX_STEPS
        rewards = np.ones(self.num_envs)
        reset = self.autoreset
        self.state = np.where(reset[:, None], 0.0, stepped)
        if reset.any():
            self.state[reset] = self.rng.uniform(-0.05, 0.05,
                                                 (int(reset.sum()), 4))
            self.steps[reset] = 0
            rewards[reset] = 0.0
            terms[reset] = False
            truncs[reset] = False
        self.autoreset = terms | truncs
        return (self.state.astype(np.float32), rewards, terms, truncs, {})


class VecPendulum:
    """Pendulum-v1 for ``n`` envs in numpy, with the interface AWR and SAC
    read from a gymnasium vector env (``num_envs``,
    ``single_observation_space.shape``, ``single_action_space.{low, high,
    shape}``, ``reset``, ``step``).  The equations and constants of
    gymnasium's ``envs/classic_control/pendulum.py`` on a float64 state
    (theta, theta_dot): g = 10, m = l = 1, dt = 0.05, speed clipped to 8,
    torque to 2, reward -(angle_normalize(theta)^2 + 0.1 theta_dot^2 +
    0.001 u^2) from the state before the step; observation (cos theta, sin
    theta, theta_dot); no termination, truncation after 200 steps (the
    TimeLimit of Pendulum-v1); the next-step autoreset of ``VecCartPole``.
    Resets draw theta ~ U(-pi, pi), theta_dot ~ U(-1, 1) with a numpy
    generator seeded by ``reset(seed)``."""
    G, M, L, DT, MAX_SPEED, MAX_TORQUE, MAX_STEPS = (10.0, 1.0, 1.0, 0.05,
                                                     8.0, 2.0, 200)

    def __init__(self, n: int):
        from types import SimpleNamespace
        self.num_envs = n
        self.single_observation_space = SimpleNamespace(shape=(3,))
        self.single_action_space = SimpleNamespace(
            low=np.full(1, -self.MAX_TORQUE, np.float32),
            high=np.full(1, self.MAX_TORQUE, np.float32), shape=(1,))
        self.rng = np.random.default_rng()
        self.state = np.zeros((n, 2))
        self.steps = np.zeros(n, np.int64)
        self.autoreset = np.zeros(n, bool)

    def _draw(self, k: int) -> np.ndarray:
        return self.rng.uniform(-np.array([np.pi, 1.0]), [np.pi, 1.0],
                                (k, 2))

    def _obs(self) -> np.ndarray:
        th, thdot = self.state[:, 0], self.state[:, 1]
        return np.stack([np.cos(th), np.sin(th), thdot],
                        axis=1).astype(np.float32)

    def reset(self, seed=None):
        self.rng = np.random.default_rng(seed)
        self.state = self._draw(self.num_envs)
        self.steps[:] = 0
        self.autoreset[:] = False
        return self._obs(), {}

    def step(self, actions):
        th, thdot = self.state[:, 0], self.state[:, 1]
        u = np.clip(np.asarray(actions, np.float32).reshape(self.num_envs),
                    -self.MAX_TORQUE, self.MAX_TORQUE)
        norm = (th + np.pi) % (2 * np.pi) - np.pi
        rewards = -(norm ** 2 + 0.1 * thdot ** 2 + 0.001 * u ** 2)
        newthdot = thdot + (3 * self.G / (2 * self.L) * np.sin(th)
                            + 3.0 / (self.M * self.L ** 2) * u) * self.DT
        newthdot = np.clip(newthdot, -self.MAX_SPEED, self.MAX_SPEED)
        self.state = np.stack([th + newthdot * self.DT, newthdot], axis=1)
        self.steps += 1
        terms = np.zeros(self.num_envs, bool)
        truncs = self.steps >= self.MAX_STEPS
        reset = self.autoreset
        if reset.any():
            self.state[reset] = self._draw(int(reset.sum()))
            self.steps[reset] = 0
            rewards[reset] = 0.0
            truncs[reset] = False
        self.autoreset = terms | truncs
        return self._obs(), rewards, terms, truncs, {}


def smi_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True)
    return out.stdout.strip().splitlines()[0]


def synthetic_ensemble(rng, policy: str, f: int = F, depth: int = DEPTH,
                       capacity: int = CAPACITY,
                       n_trees: int = N_TREES, o: int = O) -> dict:
    """An ``ensemble_to_numpy`` dict (full width by default).  Greedy:
    random feat in [-1, f) and split masks (pass-through nodes included).  Oblivious: one
    (feat, thr, is_split) per level broadcast over the level, some levels
    unsplit with feat -1.  Node data and leaf values are filled over the
    whole capacity, so trees at or beyond n_trees hold stale nonzero
    weights that must never count."""
    IN, L = (1 << depth) - 1, 1 << depth
    if policy == "oblivious":
        feat = np.empty((capacity, IN), np.int32)
        thr = np.empty((capacity, IN), np.float32)
        spl = np.empty((capacity, IN), bool)
        for d in range(depth):
            lo, k = (1 << d) - 1, 1 << d
            s = rng.random(capacity) > 0.15
            feat[:, lo:lo + k] = np.where(s, rng.integers(0, f, capacity),
                                          -1)[:, None]
            thr[:, lo:lo + k] = rng.normal(size=capacity)[:, None]
            spl[:, lo:lo + k] = s[:, None]
    else:
        feat = rng.integers(-1, f, (capacity, IN)).astype(np.int32)
        thr = rng.normal(size=(capacity, IN)).astype(np.float32)
        spl = rng.random((capacity, IN)) > 0.25
    return dict(
        feat=feat, thr=thr,
        cat_code=np.full((capacity, IN), -1, np.int32), is_split=spl,
        is_numeric=np.ones((capacity, IN), bool),
        leaf_values=rng.normal(size=(capacity, L, o)).astype(np.float32),
        counts=np.zeros((capacity, 2 * L - 1), np.float32),
        depths=np.full((capacity,), depth, np.int32),
        bias=rng.normal(size=o).astype(np.float32),
        n_trees=np.asarray(n_trees, np.int32))


def observations(rng, arrs: dict, n: int = N, f: int = F) -> np.ndarray:
    """Normal observations with x == thr ties on the first trees' root (and,
    for oblivious trees, level-1) splits."""
    X = rng.normal(size=(n, f)).astype(np.float32)
    rows = n // 16
    for k in range(8):
        for slot in (0, 1):
            col = max(int(arrs["feat"][k, slot]), 0)
            X[k * rows + slot * rows // 2:(k + 1) * rows, col] = \
                arrs["thr"][k, slot]
    return X


def cuda_ms(fn, reps: int, warmup: int = 3) -> float:
    """Median over ``reps`` single calls timed with CUDA events."""
    import torch
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        fn()
        e.record()
        torch.cuda.synchronize()
        times.append(s.elapsed_time(e))
    return float(np.median(times))


def device_ms(fn, reps: int = 20):
    """(device ms per call of ``fn``, {device activity: count per call})
    from a torch.profiler window over ``reps`` calls: each activity's mean
    duration times its (rounded) count per call, so an activity the profiler
    fails to record now and then does not lower the time.  A window with no
    device activity at all is taken again, up to three times; then
    (None, {})."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    stats = {}
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        for e in prof.events():
            if e.device_type == DeviceType.CUDA:
                n, us = stats.get(e.name, (0, 0.0))
                stats[e.name] = (n + 1, us + e.time_range.elapsed_us())
        if stats:
            break
    if not stats:
        return None, {}
    per_call = {k: max(1, round(n / reps)) for k, (n, _) in stats.items()}
    ms = sum(us / n * per_call[k] for k, (n, us) in stats.items()) / 1e3
    return ms, per_call


def enqueue_ms(fn, reps: int = 200) -> float:
    """Host time per call of ``fn`` without waiting for the card: ``reps``
    calls back to back on the host clock (the wrapper's Python, ctypes and
    launch cost; the card runs behind)."""
    import torch
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    secs = time.perf_counter() - t0
    torch.cuda.synchronize()
    return secs / reps * 1e3


def host_ms(fn, reps: int, warmup: int = 5) -> str:
    """Median and p90 wall time of ``fn`` through torch.cuda.synchronize()
    (p90 has reps / 10 samples beyond it)."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    p50, p90 = np.percentile(times, [50, 90])
    return f"p50 {p50:.4f} ms p90 {p90:.4f} ms (n={reps})"


def profile_requests(fn, n: int = 20, what: str = "request") -> None:
    """One torch.profiler window over ``n`` calls of ``fn`` (requests, or
    training steps): the device's busy share of the window and the
    operators with the most device time."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6

    def dev_us(e):
        return getattr(e, "self_device_time_total",
                       getattr(e, "self_cuda_time_total", 0.0))
    avgs = sorted(prof.key_averages(), key=dev_us, reverse=True)
    busy = sum(dev_us(e) for e in avgs)
    if busy <= 0:
        print("  profile: no device time recorded (device busy share not "
              "measured)")
        return
    print(f"  profile over {n} {what}s: wall {wall_us / n:.1f} us/{what}, "
          f"device busy {busy / n:.1f} us/{what} "
          f"({100 * busy / wall_us:.1f}% of the window)")
    for e in avgs[:8]:
        if dev_us(e) > 0:
            print(f"    {e.key[:60]:60s} calls {e.count:5d} "
                  f"device {dev_us(e) / n:8.2f} us/{what}")


def check_close(what: str, got, want) -> float:
    import torch
    assert got.shape == want.shape, (what, got.shape, want.shape)
    assert torch.isfinite(got).all(), f"{what}: non-finite output"
    err = (got.float() - want.float()).abs().max().item() if got.numel() else 0.0
    lim = RTOL * (want.abs().max().item() if want.numel() else 0.0) + ATOL
    assert err <= lim, f"{what}: max abs err {err} > {lim}"
    print(f"  {what}: max abs err {err:.3g} (limit {lim:.3g})")
    return err


# ============================================================ fit path
def fit_config(f: int = F, depth: int = DEPTH, policy: str = "greedy",
               score: str = "cosine", min_data: int = 0):
    from gbrl_tpu_torch.config import TreeConfig
    return TreeConfig(input_dim=f, output_dim=O, n_num_features=f,
                      max_depth=depth, n_bins=N_BINS, grow_policy=policy,
                      split_score_func=score, min_data_in_leaf=min_data)


def close_limit(want) -> float:
    """|got - want| allowed: RTOL of the largest finite |want|, plus ATOL."""
    import torch
    fin = want[torch.isfinite(want)]
    return RTOL * (fin.abs().max().item() if fin.numel() else 0.0) + ATOL


def max_err(got, want) -> float:
    """Largest |got - want| over finite entries; infinite entries must be
    equal."""
    import torch
    fin = torch.isfinite(want)
    assert torch.equal(fin, torch.isfinite(got)) and torch.equal(
        got[~fin], want[~fin]), "infinite entries differ"
    return (got[fin] - want[fin]).abs().max().item() if fin.any() else 0.0


def fit_inputs(cfg, X: np.ndarray, g: np.ndarray) -> dict:
    """The inputs build_tree scores a boosting step's tree from, as the
    CPU port makes them (candidates, bucket ids, scoring gradients; unit
    sample and feature weights), in numpy."""
    import torch
    from gbrl_tpu_torch.ops import candidates as C
    from gbrl_tpu_torch.ops import fit as FT
    Xt, gt = torch.from_numpy(X), torch.from_numpy(g)
    cand = C.numerical_candidates(cfg, Xt)
    ones = torch.ones(len(X))
    build = FT.standardize_l2(gt, ones) if cfg.score == "l2" else gt
    return dict(Xb=C.bucketize(Xt, cand).numpy(), cand=cand.numpy(),
                build=build.numpy(), w=ones.numpy(),
                fw=np.ones(X.shape[1], np.float32))


def route(inp: dict, tree: dict, d: int) -> np.ndarray:
    """Level-d node of every sample under the tree's levels above d (bucket
    ids against the chosen candidate's first grid position)."""
    Xb, cand = inp["Xb"], inp["cand"]
    rel = np.zeros(Xb.shape[0], np.int64)
    for lev in range(d):
        p = (1 << lev) - 1 + rel
        f = np.maximum(tree["feat"][p], 0)
        b = np.array([np.flatnonzero(cand[fi] == t)[0] if s else 0
                      for fi, t, s in zip(f, tree["thr"][p],
                                          tree["is_split"][p])])
        go = tree["is_split"][p] & (Xb[np.arange(Xb.shape[0]), f] > b)
        rel = 2 * rel + go
    return rel


def level_rows(cfg, inp: dict, tree: dict, d: int):
    """The level-d candidate scores of the CPU port's scorer (K3's plain
    version), given the tree's levels above d: [rows, F * n_bins] and the
    parents."""
    import torch
    from gbrl_tpu_torch.ops import fit as FT
    from gbrl_tpu_torch.ops import kernels as K
    B, f = cfg.n_bins, inp["Xb"].shape[1]
    n_nodes = 1 << d
    rel = torch.from_numpy(route(inp, tree, d).astype(np.int32))
    nd = FT._node_expand(rel, torch.from_numpy(inp["build"]),
                         torch.from_numpy(inp["w"]), n_nodes)
    hist = K.level_histogram_plain(torch.from_numpy(inp["Xb"]), nd, B + 1)
    blocked = torch.zeros((n_nodes, f, B), dtype=torch.bool)
    rows, _, _, parent, _ = K.level_score_rows(
        hist, blocked, torch.from_numpy(inp["fw"]), B, cfg.output_dim,
        cfg.score, cfg.min_data_in_leaf, cfg.oblivious, d == 0)
    return rows.numpy(), parent.numpy()


def compare_trees(label: str, cfg, inp: dict, card: dict, cpu: dict) -> int:
    """Hold one tree fitted on the card against another fit of the same
    step (the CPU port's, or the other tree path's): feat, is_split, thr
    and depth equal and leaf values within RTOL / ATOL; or else a near tie
    at the first level that differs (every differing node's two choices
    score within TIE_RTOL of each other, or of not splitting, on ``inp``,
    the step's fit inputs), which is printed.  Returns 1 for a near tie."""
    import torch
    D = cfg.max_depth
    for d in range(D):
        sl = slice((1 << d) - 1, (1 << (d + 1)) - 1)
        same = all(np.array_equal(card[k][sl], cpu[k][sl])
                   for k in ("feat", "is_split", "thr"))
        if not same:
            break
    else:
        assert int(card["depth"]) == int(cpu["depth"]), f"{label}: depth"
        got, want = (torch.from_numpy(np.asarray(t["leaf_values"]))
                     for t in (card, cpu))
        err = max_err(got, want)
        assert err <= close_limit(want), f"{label}: leaf values err {err}"
        return 0
    rows, parent = level_rows(cfg, inp, cpu, d)
    cand, B = inp["cand"], cfg.n_bins

    def score(tree, p, k):
        r = 0 if cfg.oblivious else k
        if not tree["is_split"][p]:
            return 0.0 if not cfg.oblivious else float("-inf")
        f = int(tree["feat"][p])
        b = int(np.flatnonzero(cand[f] == tree["thr"][p])[0])
        return float(rows[r, f * B + b])

    for k in range(1 << d):
        p = (1 << d) - 1 + k
        if all(card[key][p] == cpu[key][p]
               for key in ("feat", "is_split", "thr")):
            continue
        a, b = score(card, p, k), score(cpu, p, k)
        base = max(abs(a), abs(b)) + (0.0 if cfg.oblivious else
                                      abs(float(parent[k])))
        assert np.isfinite(a) and np.isfinite(b) and \
            abs(a - b) <= TIE_RTOL * base, (
                f"{label}: level {d} node {k} differs beyond a near tie: "
                f"card (f={card['feat'][p]}, thr={card['thr'][p]}, "
                f"split={card['is_split'][p]}) score {a!r} vs cpu "
                f"(f={cpu['feat'][p]}, thr={cpu['thr'][p]}, "
                f"split={cpu['is_split'][p]}) score {b!r}")
        print(f"  near tie {label}: level {d} node {k}: card f="
              f"{card['feat'][p]} thr={card['thr'][p]!r} score {a!r}, cpu "
              f"f={cpu['feat'][p]} thr={cpu['thr'][p]!r} score {b!r} "
              f"(|diff| {abs(a - b):.3g}, limit {TIE_RTOL * base:.3g})")
    return 1


def tree_of(arrs: dict, t: int) -> dict:
    return {k: arrs[k][t] for k in ("feat", "is_split", "thr",
                                    "leaf_values")} | {"depth": arrs["depths"][t]}


def phase_fit_parity(rng, dev):
    """Phase 6: K1-K3 against their plain versions at full width, and wide
    and deep numeric trees through build_tree.  Returns K3's arguments for
    the timing phase and the kernels' max abs errors."""
    import torch
    from gbrl_tpu_torch.ops import candidates as C
    from gbrl_tpu_torch.ops import fit as FT
    from gbrl_tpu_torch.ops import kernels as K
    print("[6 fit parity]", flush=True)
    NB = N_BINS + 1
    X = rng.normal(size=(N, F)).astype(np.float32)
    cand = C.numerical_candidates(fit_config(), torch.from_numpy(X)).numpy()
    cand[:, 100:104] = cand[:, 100:101]          # duplicate candidates
    X[:256] = cand[:, 50][None, :]               # x equal to a candidate
    X[256:300] = cand[:, 101][None, :]           # ... to a duplicated one
    X[-4:] = np.nan                              # NaN counts 0
    Xd = torch.from_numpy(X).to(dev)
    cd = torch.from_numpy(np.ascontiguousarray(cand)).to(dev)
    kb = K.bucketize_cuda(Xd, cd)
    torch.cuda.synchronize()
    assert torch.equal(kb, K.bucketize_plain(Xd, cd)), "K1 != plain"
    assert torch.equal(kb.cpu(), K.bucketize_plain(torch.from_numpy(X),
                                                   torch.from_numpy(cand)))
    print(f"  K1 bucketize [{N} x {F}] x [{F} x {N_BINS}]: bit-equal to the "
          f"plain version on the card and on the CPU (ties, duplicate "
          f"candidates, NaN rows)")
    args = {"level_score": []}
    errs = {"bucketize": 0.0, "level_histogram": 0.0, "level_score": 0.0}
    g = torch.from_numpy(rng.normal(size=(N, O)).astype(np.float32)).to(dev)
    w = torch.ones(N, device=dev)
    fw = torch.from_numpy(rng.uniform(0.5, 1.5, F).astype(np.float32)).to(dev)
    fw[5] = 0.0                                  # a zero feature weight
    for d in range(DEPTH):
        n_nodes = 1 << d
        rel = torch.from_numpy(rng.integers(0, n_nodes, N).astype(np.int32)
                               ).to(dev)
        nd = FT._node_expand(rel, g, w, n_nodes)
        h1 = K.level_histogram_cuda(kb, nd, NB)
        h2 = K.level_histogram_cuda(kb, nd, NB)
        torch.cuda.synchronize()
        assert torch.equal(h1, h2), f"K2 not deterministic at C={nd.shape[1]}"
        # the plain version sums in another order (index_add_): tolerance
        want = K.level_histogram_plain(kb, nd, NB)
        err = max_err(h1, want)
        assert err <= close_limit(want), f"K2 C={nd.shape[1]}: err {err}"
        errs["level_histogram"] = max(errs["level_histogram"], err)
        print(f"  K2 level {d} C={nd.shape[1]}: same bits on two launches; "
              f"max abs err vs plain {err:.3g} (limit "
              f"{close_limit(want):.3g})")
        blocked = torch.from_numpy(rng.random((n_nodes, F, N_BINS))
                                   < (0.05 if d else 0.0)).to(dev)
        for obl in (False, True):
            for score in ("cosine", "l2"):
                for md in (0, 40):
                    a = (h1, blocked, fw, N_BINS, O, score, md, obl, d == 0)
                    got = K.level_score_cuda(*a)
                    want = K.level_score_plain(*a)
                    torch.cuda.synchronize()
                    assert torch.equal(got[0], want[0]), (
                        f"K3 level {d} obl={obl} {score} md={md}: index "
                        f"{got[0].tolist()} vs {want[0].tolist()}")
                    err = max(max_err(x, y) for x, y in zip(got[1:],
                                                            want[1:]))
                    assert err <= 1e-6, f"K3 values err {err}"
                    errs["level_score"] = max(errs["level_score"], err)
        print(f"  K3 level {d}: indices equal to the plain version, values "
              f"max abs err {errs['level_score']:.3g} (greedy/oblivious x "
              f"cosine/l2 x min_data 0/40, a zero feature weight)")
        args["level_score"].append((h1, torch.zeros_like(blocked), fw.clone()
                                    .fill_(1.0), N_BINS, O, "cosine", 0,
                                    False, d == 0))
    # K3 past its shared-memory budget: at O = 256 one (node, feature)'s
    # rows are 257 x 257 floats, staged in global scratch
    n_nodes = 8
    gw = torch.from_numpy(rng.normal(size=(N, WIDE_SCORE_O))
                          .astype(np.float32)).to(dev)
    rel = torch.from_numpy(rng.integers(0, n_nodes, N).astype(np.int32)
                           ).to(dev)
    hw = K.level_histogram_cuda(kb, FT._node_expand(rel, gw, w, n_nodes), NB)
    blocked = torch.from_numpy(rng.random((n_nodes, F, N_BINS)) < 0.05
                               ).to(dev)
    for obl in (False, True):
        assert K._score_plan(F, n_nodes, WIDE_SCORE_O, N_BINS, obl).glob
        before = K.launch_counts["level_score"]
        a = (hw, blocked, fw, N_BINS, WIDE_SCORE_O, "cosine", 40, obl, False)
        got = K.level_score_cuda(*a)
        want = K.level_score_plain(*a)
        torch.cuda.synchronize()
        assert K.launch_counts["level_score"] == before + 1
        assert torch.equal(got[0], want[0]), (
            f"K3 O={WIDE_SCORE_O} obl={obl}: index {got[0].tolist()} vs "
            f"{want[0].tolist()}")
        err = max(max_err(x, y) for x, y in zip(got[1:], want[1:]))
        assert err <= 1e-6, f"K3 O={WIDE_SCORE_O} values err {err}"
        errs["level_score"] = max(errs["level_score"], err)
        print(f"  K3 O={WIDE_SCORE_O} ({n_nodes} nodes, "
              f"{'oblivious' if obl else 'greedy'}, rows in global "
              f"scratch): indices equal to the plain version, values max "
              f"abs err {err:.3g}")
    for f, depth in WIDE_TREES:
        cfg = fit_config(f, depth)
        Xw = rng.normal(size=(N, f)).astype(np.float32)
        gw = rng.normal(size=(N, O)).astype(np.float32)
        trees = []
        for device in (dev, torch.device("cpu")):
            Xt, gt = (torch.from_numpy(a).to(device) for a in (Xw, gw))
            before = dict(K.launch_counts)
            cand_w = C.numerical_candidates(cfg, Xt)
            tree = FT.build_tree(cfg, C.bucketize(Xt, cand_w), cand_w, gt, gt,
                                 torch.ones(N, device=device),
                                 torch.ones(f, device=device))
            if device.type == "cuda":
                torch.cuda.synchronize()
                for name, n in (("bucketize", 1), ("level_histogram", depth),
                                ("level_score", depth)):
                    assert K.launch_counts[name] == before[name] + n, \
                        f"F={f} depth={depth}: {name} not launched {n}x"
            trees.append({k: v.cpu().numpy() for k, v in tree.items()})
        ties = compare_trees(f"wide tree F={f} depth={depth}", cfg,
                             fit_inputs(cfg, Xw, gw), *trees)
        print(f"  build_tree F={f} depth={depth}: K1 once, K2/K3 {depth}x on "
              f"the card; tree equal to the CPU port's"
              + (" up to a near tie" if ties else ""))
    return args, errs


def phase_training(rng, dev) -> dict:
    """Phase 7: ActorCritic.step (shared: greedy and oblivious; separate),
    GBTLearner.fit and distil on the card, each held against the same calls
    on a CPU copy of the port.  Returns the launch counts of the phase."""
    import torch
    from gbrl_tpu_torch import ActorCritic, GBTLearner
    from gbrl_tpu_torch.ensemble import ensemble_to_numpy
    from gbrl_tpu_torch.ops import kernels as K
    print("[7 training]", flush=True)
    pol = dict(algo="SGD", lr=0.05, start_idx=0, stop_idx=O - 1)
    val = dict(algo="SGD", lr="lin_0.1", T=2000, start_idx=O - 1, stop_idx=O)
    K.reset_launch_counts()
    ties = 0
    for policy in ("greedy", "oblivious"):
        struct = dict(max_depth=DEPTH, n_bins=N_BINS, grow_policy=policy)
        models = [ActorCritic(struct, F, O, dict(pol), dict(val),
                              device=device) for device in ("cuda", "cpu")]
        seed = int(rng.integers(1 << 31))
        batches = []
        before = dict(K.launch_counts)
        for m in models:
            r = np.random.default_rng(seed)
            batches = []
            for _ in range(TRAIN_STEPS):
                Xs = r.normal(size=(N, F)).astype(np.float32)
                pg = r.normal(size=(N, O - 1)).astype(np.float32)
                vg = r.normal(size=(N,)).astype(np.float32)
                m.step(Xs, pg, vg)
                batches.append((Xs, np.concatenate([pg, vg[:, None]], 1)))
            if m is models[0]:
                torch.cuda.synchronize()
                got = {k: K.launch_counts[k] - before[k] for k in before}
                assert (got["bucketize"], got["level_histogram"],
                        got["level_score"]) == (
                    TRAIN_STEPS, 4 * TRAIN_STEPS, 4 * TRAIN_STEPS), got
        arrs = [ensemble_to_numpy(m.learner.ens) for m in models]
        assert int(arrs[0]["n_trees"]) == int(arrs[1]["n_trees"]) == \
            TRAIN_STEPS
        cfg = models[1].learner.cfg
        for t, (Xs, g) in enumerate(batches):
            ties += compare_trees(f"{policy} step {t}", cfg,
                                  fit_inputs(cfg, Xs, g),
                                  tree_of(arrs[0], t), tree_of(arrs[1], t))
        print(f"  shared {policy}: {TRAIN_STEPS} steps, launches K1 "
              f"{got['bucketize']}, K2 {got['level_histogram']}, K3 "
              f"{got['level_score']}; trees equal to the CPU port's "
              f"(near ties so far: {ties})")
        Xe = rng.normal(size=(N, F)).astype(np.float32)
        k_before = dict(K.launch_counts)
        out = [m(Xe, requires_grad=False) for m in models]
        torch.cuda.synchronize()
        key = "oblivious_leaf_sum" if policy == "oblivious" else \
            "weighted_leaf_sum"
        assert K.launch_counts[key] > k_before[key], f"{key} not launched"
        for a, b, what in zip(out[0], out[1], ("policy", "value")):
            check_close(f"trained {policy} {what} (K4/K5 vs CPU)", a,
                        b.to(dev))
        if policy == "greedy":
            # distil the trained shared learner into a fresh student
            p, v = (x.cpu().numpy() for x in out[1])
            params = dict(max_depth=DEPTH, distil_budget=DISTIL_ITERS)
            losses = [m.learner.distil(Xe, p, v, params)[0] for m in models]
            assert abs(losses[0] - losses[1]) <= FIT_LOSS_RTOL * abs(
                losses[1]), f"distil loss {losses}"
            print(f"  distil ({DISTIL_ITERS} trees): loss card {losses[0]!r}"
                  f" cpu {losses[1]!r}")
    # separate actor and critic ensembles
    struct = dict(max_depth=DEPTH, n_bins=N_BINS)
    models = [ActorCritic(struct, F, O, dict(pol), dict(val),
                          shared_tree_struct=False, device=device)
              for device in ("cuda", "cpu")]
    seed = int(rng.integers(1 << 31))
    for m in models:
        r = np.random.default_rng(seed)
        for _ in range(SEPARATE_STEPS):
            m.step(r.normal(size=(N, F)).astype(np.float32),
                   r.normal(size=(N, O - 1)).astype(np.float32),
                   r.normal(size=(N,)).astype(np.float32))
        Xs = r.normal(size=(N, F)).astype(np.float32)
        m.actor_step(Xs, r.normal(size=(N, O - 1)).astype(np.float32))
        m.critic_step(Xs, r.normal(size=(N,)).astype(np.float32))
    Xe = rng.normal(size=(N, F)).astype(np.float32)
    for a, b, what in zip(models[0](Xe), models[1](Xe), ("policy", "value")):
        check_close(f"separate {what} after {SEPARATE_STEPS} steps + actor/"
                    f"critic step", a, b.to(dev))
    # supervised fit
    X = rng.normal(size=(N, F)).astype(np.float32)
    y = np.stack([np.sin(X[:, 0]) + X[:, 1] * X[:, 2], X[:, 3] ** 2,
                  (X[:, 4] > 0) - 0.5], 1).astype(np.float32)
    losses = []
    for device in ("cuda", "cpu"):
        lr = GBTLearner(F, O, dict(max_depth=DEPTH, n_bins=N_BINS),
                        dict(algo="SGD", init_lr=0.1, start_idx=0,
                             stop_idx=O), device=device)
        lr.reset()
        losses.append(lr.fit(X, y, FIT_ITERS))
    assert abs(losses[0] - losses[1]) <= FIT_LOSS_RTOL * abs(losses[1]), \
        f"fit loss card {losses[0]} vs cpu {losses[1]}"
    print(f"  GBTLearner.fit N={N} x {FIT_ITERS} iterations: loss card "
          f"{losses[0]!r} cpu {losses[1]!r}")
    torch.cuda.synchronize()
    launches = dict(K.launch_counts)
    print(f"  launch counts over the training phase: {launches}; near ties "
          f"{ties} of {2 * TRAIN_STEPS} trees")
    for name in ("bucketize", "level_histogram", "level_score"):
        assert launches[name] > 0, f"{name} was not launched while training"
    return launches


def fit_bounds(name: str, a) -> tuple:
    """(bytes, operations) one call must at least move and do: each input
    read once, each output written once; FLOPS_PER_INSTR per compare, add,
    multiply, division or square root, counted for this call's data."""
    if name in PREDICT_KERNELS:
        # K4 / K5: X, the nodes read (K4 every node, K5 one per level) and
        # every leaf value and coefficient of the live trees, n_trees, the
        # output; a compare per level and an add per column for every
        # (sample, live tree), a product per live leaf value
        X, feat, thr, spl, lv, depth, ntd, coeff = a
        n, f = X.shape
        nt, o = int(ntd.item()), lv.shape[-1]
        L = 1 << depth
        nodes = (L - 1) if name == "weighted_leaf_sum" else depth
        nbytes = (4 * n * f + nt * nodes * 9 + 4 * nt * L * o + 4 * nt * o
                  + 4 * n * o + 4)
        ops = n * nt * (depth + o) + nt * L * o
        return nbytes, ops * FLOPS_PER_INSTR
    if name == "tree_build":
        # per level: one add per nonzero (sample, column) for each feature,
        # the prefix sums, the scores and argmax of each node's candidates
        # and one routing compare per sample; then the leaf adds
        Xb, cand, fw, bgw, wg, depth, nb, o = a[:8]
        n, f = Xb.shape
        k = o + 1
        nodes = (1 << depth) - 1
        ops = (depth * int((bgw != 0).sum().item()) * f
               + nodes * f * k * (nb + 1) + nodes * f * nb * (5 * o + 9)
               + depth * n + int((wg != 0).sum().item()))
        nbytes = (4 * (n * f + f * nb + f + 2 * n * k)
                  + depth * NPMAX * (4 + 1 + 4 * (o + 3))
                  + 4 * (1 << depth) * k)
        return nbytes, ops * FLOPS_PER_INSTR
    if name == "bucketize":
        # a search of an ascending grid needs ceil(log2(B + 1)) compares
        X, cand = a
        n, f = X.shape
        b = cand.shape[1]
        compares = n * f * math.ceil(math.log2(b + 1))
        return 4 * (2 * n * f + f * b), compares * FLOPS_PER_INSTR
    if name == "level_histogram":
        Xb, nd, nb = a
        n, f = Xb.shape
        c = nd.shape[1]
        nonzero = int((nd != 0).sum().item())     # the adds this data needs
        return 4 * (n * f + n * c + f * c * nb), nonzero * f * FLOPS_PER_INSTR
    hist, blocked, fw, _, o = a[:5]
    f, c, nb = hist.shape
    n_nodes, _, b = blocked.shape
    per_cand = 5 * o + 8          # squares, sums, 2 divisions, sqrt, masks
    ops = f * c * nb + n_nodes * f * b * per_cand
    nbytes = 4 * f * c * nb + n_nodes * f * b + 4 * f + 4 * n_nodes * (o + 4)
    return nbytes, ops * FLOPS_PER_INSTR


def fit_time_inputs(K, rng, dev, n: int, f: int) -> dict:
    """K1's and K2's arguments at one shape, made with numpy: normal
    observations against their per-feature quantile grid (N_BINS
    candidates), and one tree's four levels of node-expanded rows
    (C = n_nodes * (O + 1), each row nonzero in its node's columns only)."""
    import torch
    X = rng.normal(size=(n, f)).astype(np.float32)
    cand = np.ascontiguousarray(np.quantile(
        X, np.linspace(0, 1, N_BINS + 2)[1:-1], axis=0).T.astype(np.float32))
    Xd, cd = (torch.from_numpy(a).to(dev) for a in (X, cand))
    Xb = K.bucketize_cuda(Xd, cd)
    g = rng.normal(size=(n, O)).astype(np.float32)
    rows = np.concatenate([g, np.ones((n, 1), np.float32)], 1)
    levels = []
    for d in range(DEPTH):
        n_nodes = 1 << d
        rel = rng.integers(0, n_nodes, n)
        nd = np.zeros((n, n_nodes, O + 1), np.float32)
        nd[np.arange(n), rel] = rows
        levels.append((Xb, torch.from_numpy(nd.reshape(n, -1)).to(dev),
                       N_BINS + 1))
    return {"bucketize": [(Xd, cd)], "level_histogram": levels}


def level_score_inputs(K, dev, levels: list) -> list:
    """K3's arguments for one tree's levels, as phase 6 keeps them at the
    bench shape: K2's histogram of each level, nothing blocked, unit feature
    weights, greedy, cosine, no min-data mask."""
    import torch
    out = []
    for d, (Xb, nd, nb) in enumerate(levels):
        f = Xb.shape[1]
        out.append((K.level_histogram_cuda(Xb, nd, nb), torch.zeros(
            (1 << d, f, nb - 1), dtype=torch.bool, device=dev),
            torch.ones(f, device=dev), nb - 1, O, "cosine", 0, False, d == 0))
    return out


def library_call(name: str, a):
    """The one PyTorch call that computes the kernel's function on the same
    inputs (inputs rearranged outside the timed call), or None."""
    import torch
    if name == "bucketize":
        X, cand = a
        Xt = X.t().contiguous()                     # searchsorted's layout
        return lambda: torch.searchsorted(cand, Xt)
    if name == "level_histogram":
        Xb, nd, nb = a
        n, f = Xb.shape
        c = nd.shape[1]
        ids = (torch.arange(f, device=Xb.device)[None, :] * nb
               + Xb.long()).reshape(-1)
        src = nd[:, None, :].expand(n, f, c).reshape(n * f, c)
        out = torch.zeros((f * nb, c), device=Xb.device)
        return lambda: out.index_add_(0, ids, src)
    return None


def fit_kernel_times(name: str, calls: list, fast, plain=None,
                     plain_reps: int = KERNEL_REPS,
                     bound_calls: list = None) -> dict:
    """One kernel's times summed over ``calls`` (one tree's levels for K2
    and K3): call_ms (median single call between CUDA events), host_ms
    (enqueue time per call), kernel_ms and the device kernels per call
    (profiler), the plain version's call time, the bound (of
    ``bound_calls`` where the work the data needs is less than the
    arguments show), and the library call's call_ms / host_ms / kernel_ms
    where there is one."""
    tot = dict(call_ms=0.0, kernel_ms=0.0, host_ms=0.0, device_kernels={},
               plain_ms=0.0 if plain else None, bound_ms=0.0, t_bytes=0.0,
               t_ops=0.0, library_call_ms=None, library_kernel_ms=None,
               library_host_ms=None)
    for a, ab in zip(calls, bound_calls or calls):
        tot["call_ms"] += cuda_ms(lambda: fast(*a), KERNEL_REPS)
        tot["host_ms"] += enqueue_ms(lambda: fast(*a))
        k_ms, per_call = device_ms(lambda: fast(*a))
        tot["kernel_ms"] = (None if k_ms is None or tot["kernel_ms"] is None
                            else tot["kernel_ms"] + k_ms)
        for k, n in per_call.items():
            tot["device_kernels"][k] = max(n, tot["device_kernels"].get(k, 0))
        if plain:
            tot["plain_ms"] += cuda_ms(lambda: plain(*a), plain_reps)
        nbytes, ops = fit_bounds(name, ab)
        t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / F32_OPS_PER_S
        tot["bound_ms"] += max(t_bytes, t_ops) * 1e3
        tot["t_bytes"] += t_bytes
        tot["t_ops"] += t_ops
        lib = library_call(name, a)
        if lib is not None:
            first = tot["library_call_ms"] is None
            lk = device_ms(lib)[0]
            for key, v in (("library_call_ms", cuda_ms(lib, KERNEL_REPS)),
                           ("library_host_ms", enqueue_ms(lib)),
                           ("library_kernel_ms", lk)):
                tot[key] = (v if first else None if v is None
                            or tot[key] is None else tot[key] + v)
    tot["bound_by"] = ("bytes" if tot.pop("t_bytes") >= tot.pop("t_ops")
                       else "operations")
    return tot


DEVICE_KERNEL = {"weighted_leaf_sum": "leaf_sum_",
                 "oblivious_leaf_sum": "leaf_sum_",
                 "bucketize": "bucketize_kernel",
                 "level_histogram": "level_hist_kernel",
                 "level_score": "level_score_kernel",
                 "tree_build": "tree_build_kernel"}


def assert_one_kernel(name: str, shape: str, dk: dict) -> None:
    """One launch per call: the kernel's own device kernel, once, and
    nothing else (an empty profile is reported as kernel_ms None)."""
    assert not dk or (len(dk) == 1 and DEVICE_KERNEL[name] in next(iter(dk))
                      and next(iter(dk.values())) == 1), (
        f"{name} [{shape}]: device kernels per call {dk}")


def sync_count(fn) -> int:
    """Host synchronisations PyTorch reports while ``fn`` runs."""
    import warnings
    import torch
    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            fn()
        finally:
            torch.cuda.set_sync_debug_mode(0)
    # PyTorch's own notice that the mode "does not yet detect all
    # synchronizing operations" is not a synchronisation
    return sum("called a synchronizing CUDA operation" in str(w.message)
               for w in caught)


def phase_fit_times(rng, dev, args: dict, errs: dict, launches: dict):
    """Phase 8: training latency, fit throughput, host syncs per boosting
    step, and K1-K3 times beside their bounds, plain versions and library
    yardsticks.  Returns the kernels' JSON entries."""
    import torch
    from gbrl_tpu_torch import ActorCritic, GBTLearner
    from gbrl_tpu_torch.ensemble import init_ensemble
    from gbrl_tpu_torch.ops import kernels as K
    from gbrl_tpu_torch.ops.boosting import boost_step
    print("[8 fit times]", flush=True)
    pol = dict(algo="SGD", lr=0.05, start_idx=0, stop_idx=O - 1)
    val = dict(algo="SGD", lr="lin_0.1", T=2000, start_idx=O - 1, stop_idx=O)
    data = [(rng.normal(size=(N, F)).astype(np.float32),
             rng.normal(size=(N, O - 1)).astype(np.float32),
             rng.normal(size=(N,)).astype(np.float32))
            for _ in range(STEP_WARMUP + TRAIN_STEPS)]
    # the PPO update as a user writes it: predict, a loss, backward, then
    # step() reads the gradients (on the card) from the leaf tensors
    card_grads = [(obs, torch.from_numpy(gp).to(dev) / N,
                   torch.from_numpy(gv).to(dev) / N) for obs, gp, gv in data]

    def new_model(policy: str = "greedy"):
        return ActorCritic(dict(max_depth=DEPTH, n_bins=N_BINS,
                                grow_policy=policy), F, O, dict(pol),
                           dict(val), device="cuda")

    def backward(model, obs, gp, gv):
        p, v = model(obs)
        ((p * gp).sum() + (v * gv.reshape(v.shape)).sum()).backward()

    for policy in ("greedy", "oblivious"):
        # the two kinds of step alternate, so both see the same host load
        model, card_model = new_model(policy), new_model(policy)
        times = {"host arrays": [], "card gradients": []}
        for i, (batch, cb) in enumerate(zip(data, card_grads)):
            backward(card_model, *cb)
            for grads, run in (("host arrays", lambda: model.step(*batch)),
                               ("card gradients", card_model.step)):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                run()
                torch.cuda.synchronize()
                if i >= STEP_WARMUP:
                    times[grads].append((time.perf_counter() - t0) * 1e3)
        for grads, ts in times.items():
            p50, p90 = np.percentile(ts, [50, 90])
            print(f"  ActorCritic.step {policy} [N={N} x F={F}, {grads}]: "
                  f"p50 {p50:.4f} ms p90 {p90:.4f} ms (n={TRAIN_STEPS})")
        if policy == "greedy":
            it = iter(data * 2)
            profile_requests(lambda: model.step(*next(it)), n=10,
                             what="step")
    X = rng.normal(size=(N, F)).astype(np.float32)
    y = rng.normal(size=(N, O)).astype(np.float32)
    lr = GBTLearner(F, O, dict(max_depth=DEPTH, n_bins=N_BINS),
                    dict(algo="SGD", init_lr=0.1, start_idx=0, stop_idx=O),
                    device="cuda")
    lr.reset()
    lr.fit(X, y, 5)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    lr.fit(X, y, FIT_ITERS)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    print(f"  GBTLearner.fit N={N}: {FIT_ITERS / secs:.1f} trees/s "
          f"({secs * 1e3:.1f} ms for {FIT_ITERS} iterations)")
    # host synchronisations in one boosting step
    cfg = fit_config()
    ens = init_ensemble(cfg, 8, device="cuda")
    Xd, gd = (torch.from_numpy(a).to(dev) for a in (X, y))
    fw = torch.ones(F, device=dev)
    boost_step(cfg, ens, Xd, gd, fw)
    n_sync = sync_count(lambda: boost_step(cfg, ens, Xd, gd, fw))
    model = new_model()
    model.step(*data[0])
    n_sync_step = sync_count(lambda: model.step(*data[1]))
    backward(model, *card_grads[2])
    n_sync_card = sync_count(model.step)
    print(f"  host synchronisations: ops.boosting.boost_step (tensors on the "
          f"card) {n_sync}; ActorCritic.step (host arrays) {n_sync_step}; "
          f"ActorCritic.step (card gradients) {n_sync_card}")
    # kernel times at the shapes of the main path: K1, K2 and K3 at the
    # bench and the PPO minibatch shape (held against their plain versions
    # first); K3's bench-shape arguments come from phase 6, its PPO-shape
    # ones are built the same way from the PPO levels' histograms
    kernels = []
    shapes = {"bench": fit_time_inputs(K, rng, dev, N, F),
              "ppo": fit_time_inputs(K, rng, dev, PPO_N, PPO_F)}
    shapes["bench"]["level_score"] = args["level_score"]
    shapes["ppo"]["level_score"] = level_score_inputs(
        K, dev, shapes["ppo"]["level_histogram"])
    for shape, inp in shapes.items():
        (X, cand), = inp["bucketize"]
        assert torch.equal(K.bucketize_cuda(X, cand),
                           K.bucketize_plain(X, cand)), f"K1 {shape}"
        for a in inp["level_histogram"]:
            h = K.level_histogram_cuda(*a)
            assert torch.equal(h, K.level_histogram_cuda(*a)), f"K2 {shape}"
            want = K.level_histogram_plain(*a)
            err = max_err(h, want)
            assert err <= close_limit(want), f"K2 {shape}: err {err}"
            errs["level_histogram"] = max(errs["level_histogram"], err)
        for a in inp["level_score"]:
            got = K.level_score_cuda(*a)
            for x, y in zip(got, K.level_score_plain(*a)):
                assert torch.equal(x, y), f"K3 {shape}"
    plans = [("bucketize", K.bucketize_cuda, K.bucketize_plain),
             ("level_histogram", K.level_histogram_cuda,
              K.level_histogram_plain),
             ("level_score", K.level_score_cuda, K.level_score_plain)]
    for name, fast, plain in plans:
        times = {}
        for shape in ("bench", "ppo"):
            calls = shapes[shape][name]
            t = fit_kernel_times(name, calls, fast, plain,
                                 5 if name == "level_score" else KERNEL_REPS)
            times[shape] = t
            lib = ("none" if t["library_call_ms"] is None else
                   f"call {t['library_call_ms']:.5f} ms, host "
                   f"{t['library_host_ms']:.5f} ms, kernel "
                   f"{t['library_kernel_ms']} ms")
            print(f"  {name} [{shape}]: call {t['call_ms']:.5f} ms, host "
                  f"{t['host_ms']:.5f} ms, kernel {t['kernel_ms']} ms "
                  f"(device kernels per call {t['device_kernels']}) | plain "
                  f"{t['plain_ms']:.5f} ms | library {lib} | bound "
                  f"{t['bound_ms']:.6f} ms ({t['bound_by']})")
            assert_one_kernel(name, shape, t["device_kernels"])
        t = times["bench"]
        entry = dict(
            name=name, route="cuda", source="gbrl_tpu_torch/csrc/fit.cu",
            replaces=REPLACES[name], launches=launches[name],
            max_abs_err=errs[name], ms=t["call_ms"], plain_ms=t["plain_ms"],
            bound_ms=t["bound_ms"], bound_by=t["bound_by"],
            library_ms=t["library_call_ms"], call_ms=t["call_ms"],
            kernel_ms=t["kernel_ms"],
            host_ms=t["host_ms"], library_kernel_ms=t["library_kernel_ms"],
            library_host_ms=t["library_host_ms"])
        if "ppo" in times:
            entry["ppo_shape"] = {k: times["ppo"][k] for k in (
                "call_ms", "host_ms", "kernel_ms", "plain_ms", "bound_ms",
                "library_call_ms", "library_host_ms", "library_kernel_ms")}
        kernels.append(entry)
    print(f"  (level_histogram and level_score: sums over one tree's {DEPTH} "
          f"levels; bench N={N} F={F}, ppo N={PPO_N} F={PPO_F}; call = one "
          f"call between CUDA events, host = enqueue time per call, kernel = "
          f"profiler device time per call)")
    return kernels


# ================================================= whole tree (K6) and RL
# the PPO minibatch shape (examples/ppo_cartpole.py: 512 rows of CartPole's
# 4 features) and the bench shape at which K6 is held and timed
PPO_N, PPO_F = 512, 4
TREE_SHAPES = ((PPO_N, PPO_F), (N, F))
NPMAX = 8               # nodes per level K6 takes (depth <= 4)
# examples/ppo_cartpole.py: 16 envs x 256 steps, minibatches of 512, 4
# epochs -> 32 trees per update phase
PPO_ENVS, PPO_STEPS, PPO_BATCH, PPO_EPOCHS = 16, 256, 512, 4
PHASE_TREES = PPO_EPOCHS * PPO_ENVS * PPO_STEPS // PPO_BATCH
PPO_PHASES = 5          # update phases per PPO.learn run (phase 10)
# examples/a2c_vs_ref.py: 16 envs x 64 steps, one tree per iteration
A2C_ENVS, A2C_STEPS, A2C_ITERS = 16, 64, 20
TIMED_PHASES, PHASE_WARMUP = 12, 2   # update phases timed per path (12)
K6_RTOL = 1e-6          # K6 vs its plain version: values within 1e-6 of scale


@contextlib.contextmanager
def tree_path(k6: bool):
    """build_tree on the whole-tree path (one K6 launch per tree) or on the
    level path (K2 + K3 per level, the default)."""
    from gbrl_tpu_torch.ops import fit as FT
    FT._DISABLE_FUSED_TREE = not k6
    try:
        yield
    finally:
        FT._DISABLE_FUSED_TREE = True


@contextlib.contextmanager
def plain_steps():
    """The fused updates' steps called as plain functions on the card
    (``rl/graphs.py`` ``run_step`` swapped): the yardstick of the graph
    replays, and the way to record fits, which wait for the card and so
    cannot run under a capture."""
    from gbrl_tpu_torch.rl import graphs
    real = graphs.run_step
    graphs.run_step = lambda sets, key, dev, body: body()
    try:
        yield
    finally:
        graphs.run_step = real


@contextlib.contextmanager
def recorded_fits(module):
    """Record the inputs of every ``build_tree`` call that ``module`` makes,
    as numpy (for the near-tie check of trees that differ); yields the
    list.  The copies to the host wait for the card, so runs that are timed
    or counted for synchronisations do not use this."""
    calls = []
    real = module.build_tree

    def record(cfg, Xb, cand, grads, build, w, fw, *rest):
        calls.append(dict(Xb=Xb.cpu().numpy(), cand=cand.cpu().numpy(),
                          build=build.cpu().numpy(), w=w.cpu().numpy(),
                          fw=fw.cpu().numpy()))
        return real(cfg, Xb, cand, grads, build, w, fw, *rest)

    module.build_tree = record
    try:
        yield calls
    finally:
        module.build_tree = real


def tree_inputs(rng, dev, n: int, f: int, masked: bool, zero_fw: bool):
    """K6's arguments at one shape: bucket ids of normal observations (a
    column with repeated values) against their quantile grid, feature
    weights, and the weighted scoring and raw gradient rows (grads * w | w),
    with a fifth of the sample weights 0 when ``masked``."""
    import torch
    from gbrl_tpu_torch.ops import candidates as C
    from gbrl_tpu_torch.ops import fit as FT
    X = rng.normal(size=(n, f)).astype(np.float32)
    X[: n // 8, 0] = 0.25
    w = ((rng.random(n) > 0.2) if masked else np.ones(n)).astype(np.float32)
    fw = rng.uniform(0.5, 1.5, f).astype(np.float32)
    if zero_fw:
        fw[1] = 0.0
    Xd, wd, fwd = (torch.from_numpy(a).to(dev) for a in (X, w, fw))
    gs = [torch.from_numpy(rng.normal(size=(n, O)).astype(np.float32)).to(dev)
          for _ in range(2)]
    cand = C.numerical_candidates(fit_config(f), Xd)
    return (C.bucketize(Xd, cand), cand, fwd, FT._weighted_rows(gs[0], wd),
            FT._weighted_rows(gs[1], wd))


def phase_tree_parity(rng, dev):
    """Phase 9: K6 against its plain version on the card (indices equal,
    values within K6_RTOL of scale, the same bits on two launches), then
    build_tree's K6 path against its level path on the same inputs.
    Returns K6's arguments at the two shapes and its max abs error."""
    import torch
    from gbrl_tpu_torch.ops import candidates as C
    from gbrl_tpu_torch.ops import fit as FT
    from gbrl_tpu_torch.ops import kernels as K
    print("[9 tree parity]", flush=True)
    cases = [(n, f, DEPTH, obl, score, md, md > 0, md > 0)
             for n, f in TREE_SHAPES for obl in (False, True)
             for score in ("cosine", "l2") for md in (0, 20)]
    cases += [(700, PPO_F, DEPTH, False, "cosine", 0, True, True)]
    cases += [(PPO_N, PPO_F, d, obl, "l2", 20, True, False)
              for d in (1, 2, 3) for obl in (False, True)]
    args, err = {}, 0.0
    for n, f, depth, obl, score, md, masked, zero_fw in cases:
        a = tree_inputs(rng, dev, n, f, masked, zero_fw) + (
            depth, N_BINS, O, score, md, obl)
        got = K.tree_build_cuda(*a)
        again = K.tree_build_cuda(*a)
        want = K.tree_build_plain(*a, K._tree_tiling(n, f)[0])
        torch.cuda.synchronize()
        label = (f"K6 N={n} F={f} depth={depth} "
                 f"{'oblivious' if obl else 'greedy'} {score} min_data={md}"
                 f"{' masked w' if masked else ''}"
                 f"{' zero fw' if zero_fw else ''}")
        for x, y in zip(got, again):
            assert torch.equal(x, y), f"{label}: two launches differ"
        for x, y in zip(got[:2], want[:2]):
            assert torch.equal(x, y), f"{label}: choices differ from plain"
        e = max(max_err(x, y) for x, y in zip(got[2:], want[2:]))
        lim = K6_RTOL * max(y[torch.isfinite(y)].abs().max().item()
                            for y in want[2:])
        assert e <= lim, f"{label}: values err {e} > {lim}"
        err = max(err, e)
        if ((obl, score, md) == (False, "cosine", 0) and depth == DEPTH
                and (n, f) in TREE_SHAPES):
            args[(n, f)] = a
    print(f"  K6 on {len(cases)} cases (greedy/oblivious x cosine/l2 x "
          f"min_data 0/20 at N={PPO_N} F={PPO_F} and N={N} F={F}; masked "
          f"weights, a zero feature weight, N=700, depths 1-3): choices "
          f"equal to the plain version, values max abs err {err:.3g}, the "
          f"same bits on two launches")
    for n, f in TREE_SHAPES:
        cfg_x = rng.normal(size=(n, f)).astype(np.float32)
        g = rng.normal(size=(n, O)).astype(np.float32)
        for policy in ("greedy", "oblivious"):
            cfg = fit_config(f, DEPTH, policy)
            Xt, gt = (torch.from_numpy(x).to(dev) for x in (cfg_x, g))
            cand = C.numerical_candidates(cfg, Xt)
            Xb = C.bucketize(Xt, cand)
            trees = []
            for k6 in (True, False):
                before = K.launch_counts["tree_build"]
                with tree_path(k6):
                    t = FT.build_tree(cfg, Xb, cand, gt, gt,
                                      torch.ones(n, device=dev),
                                      torch.ones(f, device=dev))
                torch.cuda.synchronize()
                assert K.launch_counts["tree_build"] == before + int(k6)
                trees.append({k: v.cpu().numpy() for k, v in t.items()})
            ties = compare_trees(f"K6 path vs level path N={n} {policy}",
                                 cfg, fit_inputs(cfg, cfg_x, g), *trees)
            print(f"  build_tree N={n} F={f} {policy}: the K6 path's tree "
                  f"equal to the level path's"
                  + (" up to a near tie" if ties else ""))
    return args, err


def new_ppo():
    from gbrl_tpu_torch.rl import PPO
    return PPO(VecCartPole(PPO_ENVS),
               tree_struct=dict(max_depth=DEPTH, n_bins=N_BINS,
                                min_data_in_leaf=0, par_th=2,
                                grow_policy="greedy"),
               policy_lr=0.17, value_lr=0.01, n_steps=PPO_STEPS,
               batch_size=PPO_BATCH, n_epochs=PPO_EPOCHS, ent_coef=0.0,
               device="cuda")


def ppo_hyper():
    from gbrl_tpu_torch.rl.jit_update import PPOHyper
    return PPOHyper(n_actions=2, clip_range=0.2, ent_coef=0.0, vf_coef=0.5,
                    normalize_advantage=True, policy_clip=0.0, value_clip=0.0)


def compare_phase(label: str, cfg, a: dict, b: dict, fits: list,
                  nt0: int, n: int) -> str:
    """Hold trees [nt0, nt0 + n) of two ensembles (numpy dicts) fit from
    one state and rollout against each other, tree by tree (``fits`` the
    recorded inputs of ``a``'s fits).  A near tie is printed and ends the
    comparison: each tree's gradients depend on the trees before it, so the
    trees after one follow another ensemble."""
    for u in range(n):
        if compare_trees(f"{label} tree {u}", cfg, fits[u],
                         tree_of(a, nt0 + u), tree_of(b, nt0 + u)):
            return (f"trees 0-{u - 1} equal, tree {u} a near tie (later "
                    f"trees follow another ensemble)")
    return f"all {n} trees equal"


def phase_ppo(rng, dev, seed: int) -> dict:
    """Phase 10: PPO.learn on the card on both tree paths, then one update
    phase from one state and rollout on the card (K6 path, level path) and
    on the CPU port, with its launch counts and its determinism.  Returns
    what phase 12 reuses."""
    import torch
    from gbrl_tpu_torch import SharedActorCriticLearner
    from gbrl_tpu_torch.ensemble import ensemble_to_numpy
    from gbrl_tpu_torch.ops import kernels as K
    from gbrl_tpu_torch.rl import jit_update as JU
    from gbrl_tpu_torch.utils import profiling
    print("[10 PPO]", flush=True)
    steps = PPO_PHASES * PPO_ENVS * PPO_STEPS
    runs = {}
    for path in ("level", "k6"):
        algo = new_ppo()
        K.reset_launch_counts()
        t0 = time.perf_counter()
        with tree_path(path == "k6"):
            algo.learn(steps, seed=seed)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        counts = dict(K.launch_counts)
        trees = algo.model.get_num_trees()
        assert trees == PPO_PHASES * PHASE_TREES, trees
        rewards = np.asarray(algo.episode_rewards)
        assert len(rewards) and np.isfinite(rewards).all()
        mirror_c = bool(algo._mirror) and algo._mirror.uses_c_library
        assert mirror_c, "the mirror's C library did not serve the rollout"
        print(f"  PPO.learn {path} path: {steps} env steps, {trees} trees, "
              f"{len(rewards)} episodes with finite rewards, mean-100 "
              f"{algo.mean_reward():.2f}, rollouts served by the mirror's C "
              f"library: {mirror_c}; {secs:.2f} s; launches {counts}")
        fits = trees if path == "k6" else 0
        assert counts["tree_build"] == fits, counts
        assert counts["bucketize"] == trees, counts
        assert counts["level_histogram"] == counts["level_score"] == (
            0 if path == "k6" else DEPTH * trees), counts
        assert counts["weighted_leaf_sum"] >= PPO_PHASES, counts
        runs[path] = (algo, counts)
    algo = runs["level"][0]
    obs, act, old_lp, adv, ret, _, valid = algo._buffers[0].flat()
    tmp = tempfile.mkdtemp()
    path = os.path.join(tmp, "ppo_state")
    algo.model.learner.save(path)
    cfg = algo.model.learner.cfg

    def one_phase(device: str, k6: bool, graphs: bool = True):
        """One update phase; ``graphs`` False runs its steps as plain
        calls with their fits recorded (a recording waits for the card,
        which a graph's capture cannot).  Returns the ensemble, the tree
        count before, the fits, the launch counts and the ``graph.*``
        counts."""
        lr = SharedActorCriticLearner.load(path, device)
        nt0 = lr.get_num_trees()
        K.reset_launch_counts()
        before = profiling.counters()
        with tree_path(k6), (recorded_fits(JU) if not graphs else
                             contextlib.nullcontext([])) as fits, (
                plain_steps() if not graphs else contextlib.nullcontext()):
            JU.run_ppo_update(lr, obs, act, old_lp, adv, ret, ppo_hyper(),
                              PPO_EPOCHS, PPO_BATCH,
                              np.random.default_rng(seed), valid=valid)
        if device == "cuda":
            torch.cuda.synchronize()
        after = profiling.counters()
        graph = {k: after.get(k, 0) - before.get(k, 0) for k in
                 ("graph.capture", "graph.replay", "graph.eager")}
        return (ensemble_to_numpy(lr.ens), nt0, fits, dict(K.launch_counts),
                graph)

    cpu, nt0 = one_phase("cpu", False, graphs=False)[:2]
    for label, k6 in (("K6 path", True), ("level path", False)):
        card, _, fits, counts, _ = one_phase("cuda", k6, graphs=False)
        want = ((PHASE_TREES, 0, 0) if k6
                else (0, DEPTH * PHASE_TREES, DEPTH * PHASE_TREES))
        got = (counts["tree_build"], counts["level_histogram"],
               counts["level_score"])
        assert got == want and counts["bucketize"] == PHASE_TREES, counts
        verdict = compare_phase(f"PPO phase {label} vs CPU", cfg, card, cpu,
                                fits, nt0, PHASE_TREES)
        graphs = []
        for run in range(2):
            ens, _, _, g_counts, g = one_phase("cuda", k6)
            assert g_counts == counts, (g_counts, counts)
            assert g["graph.replay"] + g["graph.eager"] == PHASE_TREES, g
            assert g["graph.capture"] == g["graph.eager"] <= 1 - run, g
            for k in card:
                assert np.array_equal(card[k], ens[k]), \
                    f"{label}: graph replay {run} differs in {k}"
            graphs.append(g)
        print(f"  one update phase on the card, {label}: launches K1 "
              f"{counts['bucketize']}, K2 {counts['level_histogram']}, K3 "
              f"{counts['level_score']}, K6 {counts['tree_build']}; against "
              f"the CPU port: {verdict}; as graph replays, twice: the plain "
              f"calls' ensemble and launches ({graphs[0]}, {graphs[1]})")
    return dict(state=path, cfg=cfg, rollout=(obs, act, old_lp, adv, ret,
                                              valid),
                algo=algo, k6_launches=runs["k6"][1]["tree_build"])


def phase_a2c(rng, dev, seed: int) -> None:
    """Phase 11: A2C.learn on the card on both tree paths, then one
    run_a2c_update on the card against the CPU port."""
    import torch
    from gbrl_tpu_torch import SharedActorCriticLearner
    from gbrl_tpu_torch.ensemble import ensemble_to_numpy
    from gbrl_tpu_torch.ops import kernels as K
    from gbrl_tpu_torch.rl import A2C
    from gbrl_tpu_torch.rl import jit_a2c as JA
    from gbrl_tpu_torch.utils.host_mirror import HostMirror
    print("[11 A2C]", flush=True)
    algos = {}
    for path in ("level", "k6"):
        algo = A2C(VecCartPole(A2C_ENVS),
                   tree_struct=dict(max_depth=DEPTH, n_bins=N_BINS,
                                    min_data_in_leaf=0, par_th=2,
                                    grow_policy="oblivious"),
                   policy_lr=0.05, value_lr=0.01, policy_algo="Adam",
                   n_steps=A2C_STEPS, ent_coef=0.01, control_variates=True,
                   device="cuda")
        K.reset_launch_counts()
        t0 = time.perf_counter()
        with tree_path(path == "k6"):
            algo.learn(A2C_ITERS * A2C_ENVS * A2C_STEPS, seed=seed)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        counts = dict(K.launch_counts)
        assert algo.model.get_num_trees() == A2C_ITERS
        rewards = np.asarray(algo.episode_rewards)
        assert len(rewards) and np.isfinite(rewards).all()
        assert counts["tree_build"] == (A2C_ITERS if path == "k6" else 0)
        assert counts["level_score"] == (0 if path == "k6"
                                         else DEPTH * A2C_ITERS), counts
        assert counts["oblivious_leaf_sum"] > 0, counts
        print(f"  A2C.learn {path} path: {A2C_ITERS} iterations, "
              f"{A2C_ITERS} trees, mean-100 {algo.mean_reward():.2f}, "
              f"mirror C library {algo._mirror.uses_c_library}; {secs:.2f} "
              f"s; launches {counts}")
        algos[path] = algo
    # one update from one state and a rollout of CartPole states
    env = VecCartPole(A2C_ENVS * A2C_STEPS)
    obs, _ = env.reset(seed=seed)
    for _ in range(20):
        obs, *_ = env.step(rng.integers(0, 2, env.num_envs))
    n = len(obs)
    act = rng.integers(0, 2, n)
    adv, ret = (rng.normal(size=n).astype(np.float32) for _ in range(2))
    valid = (rng.random(n) > 0.05).astype(np.float32)
    path = os.path.join(tempfile.mkdtemp(), "a2c_state")
    algos["level"].model.learner.save(path)
    hp = JA.A2CHyper(n_actions=2, ent_coef=0.01, vf_coef=0.5,
                     normalize_advantage=True)
    out = []
    for device in ("cuda", "cpu"):
        lr = SharedActorCriticLearner.load(path, device)
        mirror = HostMirror(lr)
        with recorded_fits(JA) as fits:
            stats = JA.run_a2c_update(lr, obs, act, adv, ret, valid, hp,
                                      mirror=mirror)
        out.append((ensemble_to_numpy(lr.ens), stats, fits, mirror))
    (card, s_card, fits, m_card), (cpu, s_cpu, _, m_cpu) = out
    nt = int(cpu["n_trees"]) - 1
    ties = compare_trees("A2C update vs CPU", algos["level"].model.learner.cfg,
                         fits[0], tree_of(card, nt), tree_of(cpu, nt))
    for k in s_cpu:
        assert abs(s_card[k] - s_cpu[k]) <= FIT_LOSS_RTOL * max(
            abs(s_cpu[k]), 1e-3), (k, s_card[k], s_cpu[k])
    X = obs[:512]
    check_close("A2C mirrors after the update (card learner vs CPU)",
                torch.from_numpy(m_card.predict(X)),
                torch.from_numpy(m_cpu.predict(X)))
    print(f"  run_a2c_update (Adam policy, control variates, oblivious): the "
          f"card's tree equal to the CPU port's"
          + (" up to a near tie" if ties else "")
          + f"; stats {s_card} vs {s_cpu}")


def phase_rl_times(rng, dev, ppo: dict, tree_args: dict, tree_err: float):
    """Phase 12: the update phase's wall time on both tree paths, in turns;
    trees/s; host synchronisations; the rollout's env steps/s; the device's
    busy share of an update phase; K6's times.  Returns K6's JSON entry."""
    import torch
    from gbrl_tpu_torch import SharedActorCriticLearner
    from gbrl_tpu_torch.ensemble import ensure_capacity
    from gbrl_tpu_torch.ops import kernels as K
    from gbrl_tpu_torch.rl import jit_update as JU
    from gbrl_tpu_torch.rl.buffers import RolloutBuffer
    print("[12 RL times]", flush=True)
    obs, act, old_lp, adv, ret, valid = ppo["rollout"]
    lr = SharedActorCriticLearner.load(ppo["state"], "cuda")
    nt0 = lr.get_num_trees()
    lr.ens = ensure_capacity(lr.ens, nt0 + PHASE_TREES)
    ens0 = lr.ens
    hp = ppo_hyper()

    def phase(k6: bool):
        lr.ens, lr._rl_host_n_trees = ens0, nt0
        with tree_path(k6):
            JU.run_ppo_update(lr, obs, act, old_lp, adv, ret, hp, PPO_EPOCHS,
                              PPO_BATCH, np.random.default_rng(1),
                              valid=valid)

    times = {True: [], False: []}
    for i in range(TIMED_PHASES):
        for k6 in ((True, False) if i % 2 == 0 else (False, True)):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            phase(k6)
            torch.cuda.synchronize()
            if i >= PHASE_WARMUP:
                times[k6].append((time.perf_counter() - t0) * 1e3)
    for k6, ts in times.items():
        p50, p90 = np.percentile(ts, [50, 90])
        print(f"  PPO update phase ({PHASE_TREES} trees, rollout "
              f"{len(obs)} rows) {'K6 path' if k6 else 'level path'}: p50 "
              f"{p50:.4f} ms p90 {p90:.4f} ms (n={len(ts)}, the two paths "
              f"in turns); {PHASE_TREES / p50 * 1e3:.1f} trees/s at the p50")
    # host synchronisations: the loop alone, and the whole host wrapper
    mb_idx, mb_n = JU.minibatch_plan(len(obs), PPO_EPOCHS, PPO_BATCH,
                                     np.random.default_rng(1))
    Xn, _ = lr._prepare(obs, grow_vocab=False)
    d = [torch.from_numpy(np.asarray(a)).to(dev) for a in
         (mb_idx, act, old_lp, adv, ret, valid)]
    fw = lr._internal_feature_weights()
    for k6 in (True, False):
        with tree_path(k6):
            n_loop = sync_count(lambda: JU.ppo_update_loop(
                lr.cfg, hp, len(mb_n), ens0, Xn, d[0], mb_n.tolist(), d[1],
                d[2], d[3], d[4], lr.specs, fw, nt0, d[5]))
        n_run = sync_count(lambda: phase(k6))
        print(f"  host synchronisations, {'K6' if k6 else 'level'} path: "
              f"{n_loop} inside ppo_update_loop, {n_run} per run_ppo_update")
    # rollout: env steps per second with the host mirror serving
    algo = ppo["algo"]
    buf = RolloutBuffer(PPO_STEPS, PPO_ENVS, 4, algo.gamma, algo.gae_lambda)
    o, _ = algo.env.reset(seed=7)
    dn = np.zeros(PPO_ENVS, np.float32)
    r = np.random.default_rng(7)
    secs = []
    for _ in range(3):
        t0 = time.perf_counter()
        o, dn = algo.collect_rollout(buf, o, dn, r)
        secs.append(time.perf_counter() - t0)
    print(f"  rollout: {PPO_ENVS * PPO_STEPS / np.median(secs):.0f} env "
          f"steps/s (median of 3 rollouts of {PPO_ENVS} x {PPO_STEPS} "
          f"steps, {algo.model.get_num_trees()} trees in the mirror)")
    for k6 in (True, False):
        print(f"  {'K6' if k6 else 'level'} path:")
        profile_requests(lambda: phase(k6), n=3, what="update phase")
    # K6 at the minibatch and the bench shape: call (CUDA events), host
    # (enqueue) and kernel (profiler) time, one device kernel per call
    shapes = {}
    for (n, f), a in tree_args.items():
        tile = K._tree_tiling(n, f)[0]
        t = fit_kernel_times("tree_build", [a], K.tree_build_cuda,
                             lambda *x: K.tree_build_plain(*x, tile), 3)
        assert_one_kernel("tree_build", f"N={n} F={f}", t["device_kernels"])
        print(f"  tree_build N={n} F={f}: call {t['call_ms']:.5f} ms, host "
              f"{t['host_ms']:.5f} ms, kernel {t['kernel_ms']} ms (device "
              f"kernels per call {t['device_kernels']}) | plain "
              f"{t['plain_ms']:.5f} ms | library none | bound "
              f"{t['bound_ms']:.7f} ms ({t['bound_by']})")
        shapes[(n, f)] = {k: t[k] for k in ("call_ms", "host_ms", "kernel_ms",
                                            "plain_ms", "bound_ms",
                                            "bound_by")}
    t = shapes[(PPO_N, PPO_F)]
    entry = dict(name="tree_build", route="cuda",
                 source="gbrl_tpu_torch/csrc/tree.cu",
                 replaces=REPLACES["tree_build"],
                 launches=ppo["k6_launches"], max_abs_err=tree_err,
                 ms=t["call_ms"], plain_ms=t["plain_ms"],
                 bound_ms=t["bound_ms"],
                 bound_by=t["bound_by"],
                 library_ms=None, call_ms=t["call_ms"], host_ms=t["host_ms"],
                 kernel_ms=t["kernel_ms"], bench_shape=shapes[(N, F)])
    return entry


# ======================================= continuous control: AWR and SAC
# examples/awr_vs_ref.py:35-40: 8 Pendulum envs, rollouts of 2048 steps,
# 60 critic and 20 actor trees per iteration on minibatches of 2048
AWR_ENVS, AWR_STEPS, AWR_BATCH = 8, 2048, 2048
AWR_CRITIC_UPDATES, AWR_ACTOR_UPDATES = 60, 20
AWR_TREES = AWR_CRITIC_UPDATES + AWR_ACTOR_UPDATES
AWR_ITERS = 2                       # AWR.learn iterations per tree path
AWR_TIMED, AWR_WARMUP = 6, 1        # update phases per path (phase 13)
PENDULUM_F = 3
# examples/sac_pendulum.py's defaults: 8 envs, batches of 256, two
# gradient steps every second env step from step 1000
SAC_ENVS, SAC_BATCH, SAC_LEARN_STEPS, SAC_SHORT_STEPS = 8, 256, 3000, 1700
SAC_TIMED, SAC_WARMUP = 30, 5       # train steps timed (phase 14)
SAC_STATS_TOL = 1e-5                # card vs CPU port: rtol and atol
# K5 calls in one SAC train step, in order: the actor on the next
# observations, the two target critics (ensemble prefix), the two critics,
# the actor, the two updated critics
SAC_PREDICTS, SAC_TARGET_PREDICT = 8, 1
KERNEL_SITES = (("ops.candidates", "bucketize_cuda", "bucketize"),
                ("ops.fit", "level_histogram_cuda", "level_histogram"),
                ("ops.fit", "level_score_cuda", "level_score"),
                ("ops.predict", "oblivious_leaf_sum_cuda",
                 "oblivious_leaf_sum"))


@contextlib.contextmanager
def recorded_kernel_calls(limit: int = DEPTH):
    """Record (on the device, cloned) the arguments of the first ``limit``
    calls of K1, K2, K3 and K5 that the path makes; yields {name: [args]}.
    The clones are not kernel launches."""
    import importlib
    import torch
    calls = {name: [] for _, _, name in KERNEL_SITES}
    patched = []
    for mod, attr, name in KERNEL_SITES:
        m = importlib.import_module(f"gbrl_tpu_torch.{mod}")
        real = getattr(m, attr)

        def record(*a, _real=real, _name=name):
            if len(calls[_name]) < limit:
                calls[_name].append(tuple(
                    x.clone() if isinstance(x, torch.Tensor) else x
                    for x in a))
            return _real(*a)
        setattr(m, attr, record)
        patched.append((m, attr, real))
    try:
        yield calls
    finally:
        for m, attr, real in patched:
            setattr(m, attr, real)


def path_kernel_times(label: str, calls: dict, k5_index: int,
                      k5_stop: int = None) -> dict:
    """K1, K2 and K3 at the first tree of a path and K5 at one of its
    predicts, with the arguments the path gave them (``recorded_kernel
    _calls``): held against their plain versions (K1 and K3 equal, K2 the
    same bits on two launches and within RTOL / ATOL, K5 within RTOL / ATOL,
    and with a prefix stop ``k5_stop`` also within them of the plain version
    of the prefix alone), then call / host / kernel time, one device kernel
    per call, beside the plain version, the bound and the library call.
    Returns {name: times}."""
    import torch
    from gbrl_tpu_torch.ops import kernels as K
    (X, cand), = calls["bucketize"][:1]
    assert torch.equal(K.bucketize_cuda(X, cand),
                       K.bucketize_plain(X, cand)), f"K1 {label}"
    for a in calls["level_histogram"]:
        h = K.level_histogram_cuda(*a)
        assert torch.equal(h, K.level_histogram_cuda(*a)), f"K2 {label}"
        want = K.level_histogram_plain(*a)
        assert max_err(h, want) <= close_limit(want), f"K2 {label}"
    for a in calls["level_score"]:
        for x, y in zip(K.level_score_cuda(*a), K.level_score_plain(*a)):
            assert torch.equal(x, y), f"K3 {label}"
    k5 = calls["oblivious_leaf_sum"][k5_index]
    nt = int(k5[6].item())
    got = K.oblivious_leaf_sum_cuda(*k5)
    n, f = k5[0].shape
    o = k5[4].shape[-1]
    shape = f"N={n} F={f} O={o} n_trees={nt}"
    check_close(f"{label} oblivious_leaf_sum {shape}", got,
                K.oblivious_leaf_sum_plain(*k5[:6], nt, k5[7]))
    k5_bound = k5
    if k5_stop is not None:
        assert k5_stop < nt, (k5_stop, nt)
        check_close(f"{label} oblivious_leaf_sum {shape} against the "
                    f"plain version of the first {k5_stop} trees alone", got,
                    K.oblivious_leaf_sum_plain(*k5[:6], k5_stop, k5[7]))
        k5_bound = (k5[:6] + (torch.tensor(k5_stop, device=X.device),)
                    + k5[7:])
    plans = [("bucketize", calls["bucketize"][:1], K.bucketize_cuda,
              K.bucketize_plain, None),
             ("level_histogram", calls["level_histogram"],
              K.level_histogram_cuda, K.level_histogram_plain, None),
             ("level_score", calls["level_score"], K.level_score_cuda,
              K.level_score_plain, None),
             ("oblivious_leaf_sum", [k5], K.oblivious_leaf_sum_cuda,
              lambda *x: K.oblivious_leaf_sum_plain(*x[:6], nt, x[7]),
              [k5_bound])]
    out = {}
    for name, cl, fast, plain, bound in plans:
        t = fit_kernel_times(name, cl, fast, plain,
                             5 if name == "level_score" else KERNEL_REPS,
                             bound)
        assert_one_kernel(name, label, t["device_kernels"])
        lib = ("none" if t["library_call_ms"] is None else
               f"call {t['library_call_ms']:.5f} ms, host "
               f"{t['library_host_ms']:.5f} ms, kernel "
               f"{t['library_kernel_ms']} ms")
        where = (shape if name == "oblivious_leaf_sum"
                 else f"N={X.shape[0]} F={X.shape[1]}")
        print(f"  {name} [{label}: {where}"
              f"{', ' + str(len(cl)) + ' levels' if len(cl) > 1 else ''}]: "
              f"call {t['call_ms']:.5f} ms, host {t['host_ms']:.5f} ms, "
              f"kernel {t['kernel_ms']} ms (device kernels per call "
              f"{t['device_kernels']}) | plain {t['plain_ms']:.5f} ms | "
              f"library {lib} | bound {t['bound_ms']:.7f} ms "
              f"({t['bound_by']})")
        out[name] = {k: t[k] for k in (
            "call_ms", "host_ms", "kernel_ms", "plain_ms", "bound_ms",
            "bound_by", "library_call_ms", "library_host_ms",
            "library_kernel_ms")} | {"shape": where}
    return out


def new_awr(device: str = "cuda"):
    from gbrl_tpu_torch.rl import AWR
    return AWR(VecPendulum(AWR_ENVS),
               tree_struct=dict(max_depth=DEPTH, n_bins=N_BINS,
                                min_data_in_leaf=0, par_th=2,
                                grow_policy="oblivious"),
               feature_weights=np.ones(PENDULUM_F), actor_lr=0.05,
               critic_lr=0.05, beta=0.5, log_std_final=-1.4,
               n_steps=AWR_STEPS, actor_updates=AWR_ACTOR_UPDATES,
               critic_updates=AWR_CRITIC_UPDATES, batch_size=AWR_BATCH,
               device=device)


def launch_tuple(counts: dict) -> tuple:
    """(K1, K2, K3, K6, K5, K4) launches."""
    return tuple(counts[k] for k in ("bucketize", "level_histogram",
                                     "level_score", "tree_build",
                                     "oblivious_leaf_sum",
                                     "weighted_leaf_sum"))


def awr_launches(trees: int, k6: bool) -> tuple:
    """Launches of AWR updates that fit ``trees`` trees: one K1 and one
    K5 (the minibatch predict) per tree; K6, or K2 and K3 per level."""
    level = 0 if k6 else DEPTH * trees
    return (trees, level, level, trees if k6 else 0, trees, 0)


def launches_of(counts: dict) -> str:
    return (f"K1 {counts['bucketize']}, K2 {counts['level_histogram']}, K3 "
            f"{counts['level_score']}, K6 {counts['tree_build']}, K5 "
            f"{counts['oblivious_leaf_sum']}, K4 "
            f"{counts['weighted_leaf_sum']}")


def phase_awr(dev, seed: int, smi: str) -> dict:
    """Phase 13: AWR.learn on Pendulum on the card on both tree paths, with
    its launch and graph counts; one run_awr_update from one carried state
    on the card (both paths): its steps as plain calls against the CPU port,
    tree for tree, with their launch counts, and the graph replays against
    the plain calls, bit for bit; the update phase's wall time, trees/s, host
    synchronisations and the device's busy share; K1-K3 and K5 at the
    shapes the update gave them.  Returns those kernel times and the
    update's launches."""
    import torch
    from gbrl_tpu_torch import GBTLearner
    from gbrl_tpu_torch.ensemble import ensemble_to_numpy, ensure_capacity
    from gbrl_tpu_torch.ops import kernels as K
    from gbrl_tpu_torch.rl import jit_awr as JA
    from gbrl_tpu_torch.rl import jit_sac as JS
    from gbrl_tpu_torch.utils import profiling

    def graph_counts(before: dict) -> dict:
        after = profiling.counters()
        return {k: after.get(k, 0) - before.get(k, 0) for k in
                ("graph.capture", "graph.replay", "graph.eager")}
    print(f"[13 AWR] {smi}", flush=True)
    t_phase = time.perf_counter()
    steps = AWR_ITERS * AWR_STEPS
    for path in ("level", "k6"):
        algo = new_awr()
        K.reset_launch_counts()
        before = profiling.counters()
        t0 = time.perf_counter()
        with tree_path(path == "k6"):
            algo.learn(steps, seed=seed)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        counts = dict(K.launch_counts)
        graphs = graph_counts(before)
        assert (graphs["graph.replay"] + graphs["graph.eager"]
                == AWR_ITERS * AWR_TREES), graphs
        # one capture a learner and plan shape: the first iteration's
        # minibatches are smaller (its replay lacks the autoreset rows)
        assert graphs["graph.capture"] == graphs["graph.eager"] <= 4, graphs
        na, nc = algo.actor.get_num_trees(), algo.critic.get_num_trees()
        assert (na, nc) == (AWR_ITERS * AWR_ACTOR_UPDATES,
                            AWR_ITERS * AWR_CRITIC_UPDATES), (na, nc)
        rewards = np.asarray(algo.episode_rewards)
        assert len(rewards) and np.isfinite(rewards).all()
        assert all(m.uses_c_library for m in algo._mirrors)
        assert launch_tuple(counts) == awr_launches(
            AWR_ITERS * AWR_TREES, path == "k6"), counts
        print(f"  AWR.learn {path} path: {steps} env steps, {na} actor and "
              f"{nc} critic trees, {len(rewards)} episodes with finite "
              f"rewards, mean-100 {algo.mean_reward():.2f}, rollouts and "
              f"values served by the mirrors' C library; {secs:.2f} s; "
              f"launches {launches_of(counts)}; {graphs}")
    # one update phase from the last run's final state and replay
    replay = algo._recompute_replay()
    tmp = tempfile.mkdtemp()
    paths = {m: os.path.join(tmp, f"awr_{m}") for m in ("actor", "critic")}
    for m, p in paths.items():
        getattr(algo, m).learner.save(p)

    def loaded(device):
        a = new_awr(device)
        for m, p in paths.items():
            getattr(a, m).learner = GBTLearner.load(p, device)
        return a

    def one_update(device: str, k6: bool, record: bool = False,
                   graphs: bool = True):
        """One update; ``graphs`` False runs its steps as plain calls with
        their fits (and, with ``record``, their kernel calls) recorded: a
        recording waits for the card, which a graph's capture cannot."""
        a = loaded(device)
        nt0 = {m: getattr(a, m).get_num_trees() for m in paths}
        K.reset_launch_counts()
        before = profiling.counters()
        with tree_path(k6), (recorded_fits(JS) if not graphs else
                             contextlib.nullcontext([])) as fits, (
                recorded_kernel_calls() if record
                else contextlib.nullcontext()) as calls, (
                plain_steps() if not graphs else contextlib.nullcontext()):
            JA.run_awr_update(a, *replay[:3], np.random.default_rng(seed),
                              replay[3])
        if device == "cuda":
            torch.cuda.synchronize()
        ens = {m: ensemble_to_numpy(getattr(a, m).learner.ens)
               for m in paths}
        cfgs = {m: getattr(a, m).learner.cfg for m in paths}
        return (ens, nt0, fits, dict(K.launch_counts), calls, cfgs,
                graph_counts(before))

    cpu, nt0, _, _, _, cfgs, _ = one_update("cpu", False, graphs=False)
    update_launches, calls = {}, None
    for label, k6 in (("K6 path", True), ("level path", False)):
        card, _, fits, counts, rec, _, _ = one_update("cuda", k6, not k6,
                                                      graphs=False)
        assert launch_tuple(counts) == awr_launches(AWR_TREES, k6), counts
        verdicts = [compare_phase(f"AWR {m} {label} vs CPU", cfgs[m],
                                  card[m], cpu[m], fs, nt0[m], k)
                    for m, fs, k in (
                        ("critic", fits[:AWR_CRITIC_UPDATES],
                         AWR_CRITIC_UPDATES),
                        ("actor", fits[AWR_CRITIC_UPDATES:],
                         AWR_ACTOR_UPDATES))]
        graphs = []
        for run in range(2):
            ens, _, _, g_counts, _, _, g = one_update("cuda", k6)
            assert g_counts == counts, (g_counts, counts)
            assert g["graph.replay"] + g["graph.eager"] == AWR_TREES, g
            assert g["graph.capture"] == g["graph.eager"] <= 2 * (1 - run), g
            for m in paths:
                for k in card[m]:
                    assert np.array_equal(card[m][k], ens[m][k]), \
                        f"{label}: graph replay {run} differs in {m} {k}"
            graphs.append(g)
        print(f"  one run_awr_update on the card, {label} (replay "
              f"{len(replay[0])} rows, {AWR_CRITIC_UPDATES} critic + "
              f"{AWR_ACTOR_UPDATES} actor trees on minibatches of "
              f"{AWR_BATCH}): launches {launches_of(counts)}; the plain "
              f"calls against the CPU port: critic {verdicts[0]}, actor "
              f"{verdicts[1]}; as graph replays, twice: the plain calls' "
              f"ensembles and launches ({graphs[0]}, {graphs[1]})")
        update_launches[label] = counts
        if not k6:
            calls = rec
    # the update phase's wall time, both paths in turns
    a = loaded("cuda")
    lrs = {m: getattr(a, m).learner for m in paths}
    for lr in lrs.values():
        lr.ens = ensure_capacity(lr.ens, lr.get_num_trees() + AWR_TREES)
    start = {m: (lr.ens, lr.get_num_trees()) for m, lr in lrs.items()}

    def phase(k6: bool):
        for m, lr in lrs.items():
            lr.ens, lr._rl_host_n_trees = start[m]
        with tree_path(k6):
            JA.run_awr_update(a, *replay[:3], np.random.default_rng(1),
                              replay[3])

    times = {True: [], False: []}
    for i in range(AWR_TIMED):
        for k6 in ((True, False) if i % 2 == 0 else (False, True)):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            phase(k6)
            torch.cuda.synchronize()
            if i >= AWR_WARMUP:
                times[k6].append((time.perf_counter() - t0) * 1e3)
    for k6, ts in times.items():
        p50, p90 = np.percentile(ts, [50, 90])
        print(f"  AWR update phase ({AWR_TREES} trees, replay "
              f"{len(replay[0])} rows) {'K6 path' if k6 else 'level path'}: "
              f"p50 {p50:.4f} ms p90 {p90:.4f} ms (n={len(ts)}, the two "
              f"paths in turns); {AWR_TREES / p50 * 1e3:.1f} trees/s at "
              f"the p50")
    # host synchronisations: the loop alone, and the whole host wrapper
    B = len(replay[0])
    Xn, _ = lrs["actor"]._prepare(replay[0], grow_vocab=False)
    d = [torch.from_numpy(np.ascontiguousarray(x, np.float32)).to(dev)
         for x in (replay[1], replay[2], replay[3])]
    r = np.random.default_rng(1)
    plans = [torch.from_numpy(r.integers(0, B, (k, AWR_BATCH))).to(dev)
             for k in (AWR_CRITIC_UPDATES, AWR_ACTOR_UPDATES)]
    fw = lrs["actor"]._internal_feature_weights()
    hp = JA.AWRHyper(act_dim=1, beta=a.beta, max_weight=a.max_weight,
                     learn_std=a.learn_std, grad_clip=a.max_actor_grad_norm)
    for k6 in (True, False):
        with tree_path(k6):
            n_loop = sync_count(lambda: JA.awr_update_loop(
                lrs["actor"].cfg, lrs["critic"].cfg, hp,
                (lrs["actor"].specs, lrs["critic"].specs),
                (AWR_CRITIC_UPDATES, AWR_ACTOR_UPDATES),
                start["actor"][0], start["critic"][0], Xn, d[0], d[1],
                d[2], plans[0], plans[1], fw, rows=a.buffer_size))
        n_run = sync_count(lambda: phase(k6))
        print(f"  host synchronisations, {'K6' if k6 else 'level'} path: "
              f"{n_loop} inside awr_update_loop, {n_run} per run_awr_update")
        assert n_loop == 0, f"awr_update_loop synchronised {n_loop} times"
        print(f"  {'K6' if k6 else 'level'} path:")
        profile_requests(lambda: phase(k6), n=1, what="update phase")
    times = path_kernel_times("awr", calls, 0)
    print(f"  phase 13 took {time.perf_counter() - t_phase:.1f} s")
    return dict(times=times, launches=update_launches)


def new_sac(q: str = "linear", device: str = "cuda"):
    from gbrl_tpu_torch.rl import SAC
    return SAC(VecPendulum(SAC_ENVS), q_func_type=q, actor_lr=0.02,
               critic_lr=0.1, gamma=0.9, n_step=10, gradient_steps=2,
               learning_starts=1000, batch_size=SAC_BATCH, train_freq=2,
               target_update_interval=100, device=device)


def sac_train_steps(steps: int) -> int:
    """The train steps SAC.learn takes in ``steps`` env steps at the
    defaults above (learning_starts 1000, train_freq 2, 2 gradient steps)."""
    its = steps // SAC_ENVS
    first = -(-1000 // SAC_ENVS)
    return 2 * sum(1 for it in range(first, its + 1) if it % 2 == 0)


def sac_launches(steps: int) -> tuple:
    """Launches of ``steps`` SAC train steps on the level path: three trees
    (K1, and K2 and K3 per level) and SAC_PREDICTS K5 predicts a step."""
    return (3 * steps, 3 * DEPTH * steps, 3 * DEPTH * steps, 0,
            SAC_PREDICTS * steps, 0)


def sac_step_args(s, batch, eps):
    """sac_train_step's arguments for the SAC ``s`` (its ensembles given
    room for one more tree) on one batch and one pair of noise draws, on
    its learners' device."""
    import torch
    from gbrl_tpu_torch.ensemble import ensure_capacity
    from gbrl_tpu_torch.rl import jit_sac as JS
    lrs = [s.actor.learner] + [c.learner for c in s.critics]
    for lr in lrs:
        lr.ens = ensure_capacity(lr.ens, lr.get_num_trees() + 1)
    dev = lrs[0].torch_device
    t = [torch.from_numpy(np.ascontiguousarray(x, np.float32)).to(dev)
         for x in batch]
    obs, act, rew, nobs, done, disc = t
    hp = JS.SACHyper(act_dim=s.act_dim, q_func_type=s.q_func_type,
                     max_grad_norm=s.max_grad_norm)
    return (lrs[0].cfg, lrs[1].cfg, hp, (lrs[0].specs, lrs[1].specs),
            lrs[0].ens, tuple(lr.ens for lr in lrs[1:]),
            torch.tensor([c.target_prefix for c in s.critics],
                         dtype=torch.int32, device=dev),
            obs, act.reshape(-1, s.act_dim), rew, nobs, done, disc,
            torch.tensor(s.alpha, device=dev),
            lrs[0]._internal_feature_weights(),
            *(torch.from_numpy(e).to(dev) for e in eps))


def phase_sac(dev, seed: int, smi: str) -> dict:
    """Phase 14: SAC.learn on Pendulum on the card (linear Q, twin
    critics) with its launch and graph counts (one replay of the boosting
    body a train step, one capture a key); one sac_train_step from one
    carried state, with the same noise, on the card (its body as a plain
    call) and on the CPU port, for each Q-form, tree for tree and stats
    within SAC_STATS_TOL, with its launch counts, and the graph replay
    against the plain call, bit for bit, twice; the train step's wall time,
    host synchronisations and graph replays; K1-K3 and K5 (the target's
    prefix predict) at the shapes the step gave them.  Returns those
    kernel times and the step's launches."""
    import torch
    from gbrl_tpu_torch import GBTLearner
    from gbrl_tpu_torch.ensemble import ensemble_to_numpy
    from gbrl_tpu_torch.ops import kernels as K
    from gbrl_tpu_torch.rl import jit_sac as JS
    from gbrl_tpu_torch.utils import profiling

    def graph_counts(before: dict) -> dict:
        after = profiling.counters()
        return {k: after.get(k, 0) - before.get(k, 0) for k in
                ("graph.capture", "graph.replay", "graph.eager")}
    print(f"[14 SAC] {smi}", flush=True)
    t_phase = time.perf_counter()
    states = {}
    for q, steps in (("linear", SAC_LEARN_STEPS),
                     ("quadratic", SAC_SHORT_STEPS),
                     ("tanh", SAC_SHORT_STEPS)):
        algo = new_sac(q)
        K.reset_launch_counts()
        before = profiling.counters()
        t0 = time.perf_counter()
        algo.learn(steps, seed=seed)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        counts = dict(K.launch_counts)
        graphs = graph_counts(before)
        n = sac_train_steps(steps)
        nts = [algo.actor.get_num_trees()] + [c.get_num_trees()
                                              for c in algo.critics]
        assert nts == [n] * 3, (nts, n)
        assert launch_tuple(counts) == sac_launches(n), counts
        assert graphs["graph.replay"] + graphs["graph.eager"] == n, graphs
        assert graphs["graph.capture"] == graphs["graph.eager"] <= 1, graphs
        rewards = np.asarray(algo.episode_rewards)
        assert len(rewards) and np.isfinite(rewards).all()
        assert np.isfinite(algo.alpha) and algo._mirror.uses_c_library
        prefixes = [c.target_prefix for c in algo.critics]
        if q == "linear":
            assert 0 < prefixes[0] < n, prefixes
        else:
            for c in algo.critics:      # a prefix stop below n_trees
                c.target_prefix = n // 2
        print(f"  SAC.learn {q}: {steps} env steps, {n} train steps, {n} "
              f"actor and 2 x {n} critic trees, {len(rewards)} episodes "
              f"with finite rewards, mean-100 {algo.mean_reward():.2f}, "
              f"alpha {algo.alpha:.5f}, target prefixes {prefixes}; "
              f"{secs:.2f} s; launches {launches_of(counts)}; {graphs}")
        states[q] = algo
    # one train step from each carried state: card and CPU, same noise
    step_launches = calls = None
    for q, algo in states.items():
        tmp = tempfile.mkdtemp()
        models = [algo.actor] + algo.critics
        paths = [os.path.join(tmp, f"sac_{i}") for i in range(len(models))]
        for m, p in zip(models, paths):
            m.learner.save(p)
        r = np.random.default_rng(seed + 1)
        batch = algo.buffer.sample(SAC_BATCH, r)
        eps = r.normal(size=(2, SAC_BATCH, 1)).astype(np.float32)
        def one_step(device: str, graphs: bool = False):
            """One sac_train_step from the saved state; ``graphs`` False
            calls its body plainly with its fits (and, for the linear
            Q-form on the card, its kernel calls) recorded: a recording
            waits for the card, which a graph's capture cannot."""
            s = new_sac(q, device)
            s.log_alpha = algo.log_alpha.detach().clone()
            for m, p in zip([s.actor] + s.critics, paths):
                m.learner = GBTLearner.load(p, device)
            for c, ca in zip(s.critics, algo.critics):
                c.target_prefix = ca.target_prefix
            args = sac_step_args(s, batch, eps)
            K.reset_launch_counts()
            before = profiling.counters()
            with (recorded_fits(JS) if not graphs else
                  contextlib.nullcontext([])) as fits, (
                    recorded_kernel_calls() if device == "cuda" and
                    q == "linear" and not graphs
                    else contextlib.nullcontext()) as rec, (
                    plain_steps() if not graphs
                    else contextlib.nullcontext()):
                new_actor, new_critics, stats = JS.sac_train_step(*args)
            vals = {k: float(v) for k, v in stats.items()}
            return ([ensemble_to_numpy(e) for e in
                     (new_actor,) + new_critics], vals, fits,
                    dict(K.launch_counts), rec,
                    [m.learner.cfg for m in [s.actor] + s.critics],
                    graph_counts(before))

        card, s_card, fits, counts, rec, cfgs, _ = one_step("cuda")
        cpu, s_cpu = one_step("cpu")[:2]
        assert launch_tuple(counts) == sac_launches(1), counts
        replays = []
        for run in range(2):
            ens, s_graph, _, g_counts, _, _, g = one_step("cuda", True)
            assert g_counts == counts, (g_counts, counts)
            assert g["graph.replay"] + g["graph.eager"] == 1, g
            assert g["graph.capture"] == g["graph.eager"] <= 1 - run, g
            assert s_graph == s_card, (q, run, s_graph, s_card)
            for e_graph, e_plain in zip(ens, card):
                for k in e_plain:
                    assert np.array_equal(e_graph[k], e_plain[k]), \
                        f"SAC {q}: graph replay {run} differs in {k}"
            replays.append(g)
        nt0 = algo.actor.get_num_trees()
        ties = sum(compare_trees(f"SAC {q} {what} vs CPU", cfg, fit,
                                 tree_of(c, nt0), tree_of(p, nt0))
                   for what, cfg, fit, c, p in zip(
                       ("critic 1", "critic 2", "actor"),
                       cfgs[1:] + cfgs[:1], fits, card[1:] + card[:1],
                       cpu[1:] + cpu[:1]))
        for k in s_cpu:
            assert abs(s_card[k] - s_cpu[k]) <= SAC_STATS_TOL * (
                1 + abs(s_cpu[k])), (q, k, s_card[k], s_cpu[k])
        print(f"  one sac_train_step {q} (target prefixes "
              f"{[c.target_prefix for c in algo.critics]} of {nt0} trees): "
              f"launches {launches_of(counts)}; the 3 trees equal to the "
              f"CPU port's" + (f" ({ties} a near tie)" if ties else "")
              + f"; stats {s_card} vs {s_cpu}; as graph replays, twice: "
              f"the plain call's ensembles, stats and launches ({replays[0]},"
              f" {replays[1]})")
        if q == "linear":
            step_launches, calls = {"level path": counts}, rec
            prefix = algo.critics[0].target_prefix
    # the train step's wall time and host synchronisations, on from the
    # linear run's state
    algo = states["linear"]
    gen = torch.Generator(device=dev).manual_seed(seed)
    r = np.random.default_rng(seed)

    def step():
        JS.run_sac_train_step(algo, *algo.buffer.sample(SAC_BATCH, r), gen)

    print(f"  SAC train step [batch {SAC_BATCH}, "
          f"{algo.actor.get_num_trees()} trees]: "
          f"{host_ms(step, SAC_TIMED, SAC_WARMUP)}")
    before = profiling.counters()
    n_sync = sync_count(step)
    g = graph_counts(before)
    print(f"  host synchronisations per run_sac_train_step: {n_sync}; {g}")
    assert n_sync == 1, f"run_sac_train_step synchronised {n_sync} times"
    assert g == {"graph.capture": 0, "graph.replay": 1, "graph.eager": 0}, g
    profile_requests(step, n=10, what="train step")
    times = path_kernel_times("sac", calls, SAC_TARGET_PREDICT, prefix)
    print(f"  phase 14 took {time.perf_counter() - t_phase:.1f} s")
    return dict(times=times, launches=step_launches)


# ============================================ 15 explain and export
SHAP_TREES = 400        # trees grown per policy before SHAP and export
SHAP_HALF = 200         # the snapshot whose SHAP syncs must equal the full's
SHAP_CPU_ROWS = 512     # rows held against the CPU twin
SHAP_ORACLE_ROWS = 8    # rows held against the host recursion
SHAP_REF_ROWS = 64      # rows of the reference-compatible form
SHAP_CALLS = 10         # timed shap calls per policy (p90: 1 beyond)
SHAP_ORACLE_TREES = (0, SHAP_HALF - 1, SHAP_TREES - 1)
MIXED_F = (2, 4)        # numeric and categorical columns of the mixed model
MIXED_TREES = 20
# card SHAP against the CPU port (the tree sums run in another order):
# |card - cpu| <= SHAP_RTOL * max|cpu| + SHAP_ATOL
SHAP_RTOL, SHAP_ATOL = 1e-5, 1e-6
# the JAX tests' tolerances (tests/test_shap.py:98): the recursion, and the
# local accuracy sum_f phi + E_raw = sum_t leaf_t(x), whose absolute part
# scales with the raw sum (400 float32 trees summed in other orders)
ORACLE_TOL = dict(rtol=1e-4, atol=1e-5)
EXPORT_RTOL = 1e-4      # compiled header vs the card: 1e-4 * max(1, max|card|)


def expected_raw(arrs: dict, depth: int, n_trees: int) -> np.ndarray:
    """E_raw[o] = sum over live trees of the tree's expectation under the
    edge weights counts[child] / counts[parent] (what SHAP's value
    function gives the empty subset), float64, vectorized over trees."""
    L = 1 << depth
    lv = arrs["leaf_values"][:n_trees].astype(np.float64)
    c = arrs["counts"][:n_trees].astype(np.float64)
    spl = arrs["is_split"][:n_trees]

    def ev(p: int, d: int) -> np.ndarray:
        q = p
        for _ in range(d, depth):
            q = 2 * q + 1
        leaf = lv[:, q - (L - 1)]
        if d == depth:
            return leaf
        pc = c[:, p:p + 1]
        safe = np.where(pc > 0, pc, 1.0)
        split = (np.where(pc > 0, c[:, 2 * p + 1:2 * p + 2] / safe, 0.0)
                 * ev(2 * p + 1, d + 1)
                 + np.where(pc > 0, c[:, 2 * p + 2:2 * p + 3] / safe, 0.0)
                 * ev(2 * p + 2, d + 1))
        return np.where(spl[:, p:p + 1], split, leaf)
    return ev(0, 0).sum(axis=0)


def grow_shared(policy: str, seed: int, trees: int, n: int, snap: str):
    """A shared ActorCritic grown on the card by ``trees`` steps on
    synthetic gradients (seeded); saved to ``snap`` after ``trees // 2``.
    Returns the model and the launches of K1-K3 over the steps."""
    import torch
    from gbrl_tpu_torch import ActorCritic
    from gbrl_tpu_torch.ops import kernels as K
    pol = dict(algo="SGD", lr=0.05, start_idx=0, stop_idx=O - 1)
    val = dict(algo="SGD", lr="lin_0.1", T=2000, start_idx=O - 1,
               stop_idx=O)
    m = ActorCritic(dict(max_depth=DEPTH, n_bins=N_BINS, grow_policy=policy),
                    F, O, pol, val, device="cuda")
    r = np.random.default_rng(seed)
    before = dict(K.launch_counts)
    for i in range(trees):
        m.step(r.normal(size=(n, F)).astype(np.float32),
               r.normal(size=(n, O - 1)).astype(np.float32),
               r.normal(size=(n,)).astype(np.float32))
        if i + 1 == trees // 2:
            m.save_learner(snap)
    torch.cuda.synchronize()
    got = {k: K.launch_counts[k] - before[k] for k in before}
    return m, got


def phase_explain(dev, seed: int, smi: str, trees: int = SHAP_TREES,
                  n: int = N) -> dict:
    """Phase 15: SHAP and the utils on ensembles grown on the card.  Grows
    a shared ActorCritic per policy (K1-K3 launches asserted) and a mixed
    GBTModel; holds the card's SHAP against the CPU twin, the host
    recursion and local accuracy (the raw leaf sum through K4 / K5);
    tree_shap against the recursion, ref_compat bit-equal to the CPU twin;
    times SHAP, counts its host syncs (equal at half and all the trees),
    its peak memory and device busy share; exports a float header, builds
    it and holds it against the card's predict; prints and plots a tree;
    round-trips the reference format on the card; traces one call.
    Returns the launch counts of the phase."""
    import contextlib as ctx
    import io
    import torch
    from gbrl_tpu_torch import ActorCritic, GBTModel
    from gbrl_tpu_torch.ensemble import ensemble_to_numpy
    from gbrl_tpu_torch.ops import kernels as K
    from gbrl_tpu_torch.ops import shap as H
    from gbrl_tpu_torch.ops.predict import weighted_leaf_sum
    from gbrl_tpu_torch.utils import profiling
    from gbrl_tpu_torch.utils.c_runtime import CompiledModel
    from gbrl_tpu_torch.utils.reference_import import load_reference_model
    print(f"[15 explain/export] {smi}", flush=True)
    t_phase = time.perf_counter()
    rng = np.random.default_rng(seed + 15)
    tmp = tempfile.mkdtemp()
    K.reset_launch_counts()
    rows = min(n, SHAP_CPU_ROWS)
    oracle_trees = [t for t in SHAP_ORACLE_TREES if t < trees]
    obs = rng.normal(size=(n, F)).astype(np.float32)
    obs_dev = torch.from_numpy(obs).to(dev)
    for policy in ("greedy", "oblivious"):
        # -- grow on the card; its twin on the CPU from the checkpoint
        snap = os.path.join(tmp, f"{policy}_half")
        t0 = time.perf_counter()
        card, got = grow_shared(policy, seed + (policy == "oblivious"),
                                trees, n, snap)
        grow_s = time.perf_counter() - t0
        assert (got["bucketize"], got["level_histogram"],
                got["level_score"]) == (trees, DEPTH * trees,
                                        DEPTH * trees), got
        path = os.path.join(tmp, policy)
        card.save_learner(path)
        cpu = ActorCritic.load_learner(path, device="cpu")
        learner = card.learner
        cfg = learner.cfg
        assert card.get_num_trees() == cpu.get_num_trees() == trees
        print(f"  {policy}: {trees} ActorCritic.step on the card in "
              f"{grow_s:.2f} s, launches K1 {got['bucketize']}, K2 "
              f"{got['level_histogram']}, K3 {got['level_score']}")
        # -- SHAP on the card against the CPU twin, the recursion and
        # local accuracy
        phi = card.shap(obs)
        assert isinstance(phi, np.ndarray) and phi.shape == (n, F, O)
        assert np.isfinite(phi).all()
        want = cpu.shap(obs[:rows])
        err = np.abs(phi[:rows] - want).max()
        lim = SHAP_RTOL * np.abs(want).max() + SHAP_ATOL
        assert err <= lim, f"{policy} shap card vs cpu {err} > {lim}"
        print(f"  {policy} shap [N={n}, F={F}, O={O}, {trees} trees]: "
              f"first {rows} rows against the CPU port, max abs "
              f"err {err:.3g} (limit {lim:.3g})")
        arrs = ensemble_to_numpy(learner.ens)
        x8 = obs[:SHAP_ORACLE_ROWS]
        np.testing.assert_allclose(phi[:SHAP_ORACLE_ROWS],
                                   H.ensemble_shap_values(cfg, arrs, x8),
                                   **ORACLE_TOL)
        for t in oracle_trees:
            np.testing.assert_allclose(card.tree_shap(t, x8),
                                       H.tree_shap_values(cfg, arrs, t, x8),
                                       **ORACLE_TOL)
        print(f"  {policy} shap and tree_shap {oracle_trees} on "
              f"{SHAP_ORACLE_ROWS} rows against the host recursion: within "
              f"rtol {ORACLE_TOL['rtol']}, atol {ORACLE_TOL['atol']}")
        key = ("oblivious_leaf_sum" if policy == "oblivious"
               else "weighted_leaf_sum")
        cap = learner.ens.capacity
        unit = (torch.arange(cap, device=dev) < trees).float()[:, None]
        before = K.launch_counts[key]
        raw = weighted_leaf_sum(cfg, learner.ens, obs_dev,
                                unit.expand(cap, O).contiguous())
        torch.cuda.synchronize()
        assert K.launch_counts[key] == before + 1, f"{key} not launched"
        raw = raw.cpu().numpy().astype(np.float64)
        lhs = phi.astype(np.float64).sum(axis=1) + expected_raw(
            arrs, DEPTH, trees)
        atol = ORACLE_TOL["atol"] * max(1.0, np.abs(raw).max())
        np.testing.assert_allclose(lhs, raw, rtol=ORACLE_TOL["rtol"],
                                   atol=atol)
        print(f"  {policy} local accuracy on {n} rows, sum_f phi + E_raw "
              f"against the raw leaf sum ({key}, unit coefficients): max "
              f"abs err {np.abs(lhs - raw).max():.3g} (rtol "
              f"{ORACLE_TOL['rtol']}, atol {atol:.3g})")
        refc = card.shap(obs[:SHAP_REF_ROWS], ref_compat=True)
        assert np.array_equal(refc, cpu.shap(obs[:SHAP_REF_ROWS],
                                             ref_compat=True))
        print(f"  {policy} shap(ref_compat=True) on {SHAP_REF_ROWS} rows: "
              f"bit-equal to the CPU port")
        # -- SHAP's cost
        print(f"  {policy} shap time [N={n}, {trees} trees]: host obs "
              f"{host_ms(lambda: card.shap(obs), SHAP_CALLS, 2)}; card obs "
              f"{host_ms(lambda: card.shap(obs_dev), SHAP_CALLS, 2)}")
        half = ActorCritic.load_learner(snap, device="cuda")
        assert half.get_num_trees() == trees // 2
        syncs = [sync_count(lambda m=m: m.shap(obs_dev)) for m in (half, card)]
        print(f"  {policy} host syncs per shap call (card obs): "
              f"{syncs[0]} at {trees // 2} trees, {syncs[1]} at {trees}")
        assert syncs[0] == syncs[1], syncs
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        card.shap(obs_dev)
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated()
        print(f"  {policy} shap peak device memory: "
              f"{peak / 2**20:.1f} MiB allocated at the peak, "
              f"{(peak - base) / 2**20:.1f} MiB of it the call's own")
        profile_requests(lambda: card.shap(obs_dev), n=1, what="shap call")
        # -- export: a float header built on the host against the card
        t0 = time.perf_counter()
        rt = CompiledModel.from_learner(learner)
        build_s = time.perf_counter() - t0
        want = learner.predict_async(obs)
        host = rt(obs)
        want = want.cpu().numpy()
        err = np.abs(host - want).max()
        lim = EXPORT_RTOL * max(1.0, np.abs(want).max())
        assert err <= lim, f"{policy} compiled header {err} > {lim}"
        print(f"  {policy} export + CompiledModel build {build_s:.2f} s; "
              f"host predict on {n} rows against the card's "
              f"({key}): max abs err {err:.3g} (limit {lim:.3g})")
        texts = []
        for m in (card, cpu):
            buf = io.StringIO()
            with ctx.redirect_stdout(buf):
                m.print_tree(0)
            texts.append(buf.getvalue())
        assert texts[0] == texts[1] and texts[0].startswith("Tree 0")
        plot = os.path.join(tmp, f"{policy}_tree")
        card.plot_tree(0, plot)
        made = [p for p in (plot + ".png", plot + ".dot")
                if os.path.exists(p)]
        assert made, "plot_tree wrote no file"
        print(f"  {policy} print_tree(0) equal to the CPU port's "
              f"({len(texts[0].splitlines())} lines); plot_tree wrote "
              f"{os.path.basename(made[0])}")
        # -- the reference format round trip on the card
        ref = os.path.join(tmp, f"{policy}.ref")
        learner.save_reference_format(ref)
        back = load_reference_model(ref, device="cuda")
        assert back.ens.feat.device == learner.ens.feat.device
        check_close(f"{policy} reference round trip predict ({key})",
                    back.predict_async(obs), learner.predict_async(obs))
        sb = back.shap(obs)
        err = np.abs(sb - phi).max()
        lim = SHAP_RTOL * np.abs(phi).max() + SHAP_ATOL
        assert err <= lim, f"{policy} reference round trip shap {err}"
        print(f"  {policy} reference round trip shap (imported counts are "
              f"path probabilities): max abs err {err:.3g} (limit "
              f"{lim:.3g})")
    # -- a mixed model: more categorical than numeric columns
    fn, fc = MIXED_F
    X = np.empty((n, fn + fc), dtype=object)
    X[:, :fn] = rng.normal(size=(n, fn)).astype(np.float32)
    X[:, fn:] = rng.choice(["a", "b", "c", "d", "e"], (n, fc))
    mixed = GBTModel(dict(max_depth=DEPTH, n_bins=N_BINS), fn + fc, O,
                     dict(algo="SGD", lr=0.1, start_idx=0, stop_idx=O),
                     device="cuda")
    for _ in range(MIXED_TREES):
        mixed.step(X, grads=rng.normal(size=(n, O)).astype(np.float32))
    path = os.path.join(tmp, "mixed")
    mixed.save_learner(path)
    twin = GBTModel.load_learner(path, device="cpu")
    got = mixed.shap(X[:rows])
    want = twin.shap(X[:rows])
    err = np.abs(got - want).max()
    lim = SHAP_RTOL * np.abs(want).max() + SHAP_ATOL
    assert got.shape == (rows, fn + fc, O) and err <= lim, (got.shape, err)
    print(f"  mixed GBTModel (F = {fn} numeric + {fc} categorical, "
          f"{MIXED_TREES} trees) shap on {rows} rows against the "
          f"CPU port: max abs err {err:.3g} (limit {lim:.3g})")
    # -- profiling: one traced shap call
    trace_dir = os.path.join(tmp, "trace")
    with profiling.trace(trace_dir):
        with profiling.annotate("shap"):
            card.shap(obs_dev)
        torch.cuda.synchronize()
    files = [f for f in os.listdir(trace_dir)
             if f.endswith(".pt.trace.json")]
    assert len(files) == 1, files
    with open(os.path.join(trace_dir, files[0])) as f:
        events = json.load(f)["traceEvents"]
    kernels = {e["name"] for e in events if e.get("cat") == "kernel"}
    assert kernels, "the trace names no CUDA kernel"
    assert any(e.get("name") == "shap" for e in events), "no annotation"
    print(f"  profiling.trace: {files[0]} names {len(kernels)} CUDA "
          f"kernels and the 'shap' annotation")
    torch.cuda.synchronize()
    launches = dict(K.launch_counts)
    print(f"  launch counts over phase 15: {launches_of(launches)}")
    for name in ("bucketize", "level_histogram", "level_score",
                 "weighted_leaf_sum", "oblivious_leaf_sum"):
        assert launches[name] > 0, f"{name} was not launched in phase 15"
    print(f"  phase 15 took {time.perf_counter() - t_phase:.1f} s")
    return launches


def phase_predict_times(rng, dev, kernel_args: dict, launches: dict,
                        errs: dict) -> list:
    """Phase 5, kernels: K4 and K5 at the serving shape (greedy for K4,
    oblivious for K5) and at the RL shapes of PREDICT_TIMES (first held
    against their plain versions): call_ms (one call between CUDA events),
    host_ms (enqueue) and kernel_ms (profiler; one device kernel per call is
    asserted), the plain version's call time and the bound.  Returns the
    two kernels' JSON entries."""
    import torch
    from gbrl_tpu_torch.ops import kernels as K
    fns = {"weighted_leaf_sum": (K.weighted_leaf_sum_cuda,
                                 K.weighted_leaf_sum_plain),
           "oblivious_leaf_sum": (K.oblivious_leaf_sum_cuda,
                                  K.oblivious_leaf_sum_plain)}
    cases = [("serving", "weighted_leaf_sum",
              kernel_args[("weighted_leaf_sum", "greedy")], N_TREES),
             ("serving", "oblivious_leaf_sum",
              kernel_args[("oblivious_leaf_sum", "oblivious")], N_TREES)]
    for label, name, policy, n, f, cap, nt in PREDICT_TIMES:
        arrs = synthetic_ensemble(rng, policy, f, DEPTH, cap, nt)
        t = [torch.from_numpy(np.ascontiguousarray(a)).to(dev) for a in
             (observations(rng, arrs, n, f), arrs["feat"], arrs["thr"],
              arrs["is_split"], arrs["leaf_values"])]
        cd = torch.from_numpy(rng.uniform(0.01, 0.1, size=(cap, O))
                              .astype(np.float32)).to(dev)
        ntd = torch.tensor(nt, dtype=torch.int32, device=dev)
        a = tuple(t) + (DEPTH, ntd, cd)
        fast, plain = fns[name]
        got = fast(*a)
        torch.cuda.synchronize()
        check_close(f"{label} {name} N={n} F={f} n_trees={nt}", got,
                    plain(*t, DEPTH, nt, cd))
        cases.append((label, name, a, nt))
    shapes = {name: {} for name in fns}
    for label, name, a, nt in cases:
        fast, plain = fns[name]
        tm = fit_kernel_times(name, [a], fast,
                              lambda *x: plain(*x[:6], nt, x[7]))
        n, f = a[0].shape
        assert_one_kernel(name, label, tm["device_kernels"])
        print(f"  {name} [{label}: N={n} F={f} n_trees={nt} of "
              f"{a[1].shape[0]}]: call {tm['call_ms']:.5f} ms, host "
              f"{tm['host_ms']:.5f} ms, kernel {tm['kernel_ms']} ms (device "
              f"kernels per call {tm['device_kernels']}) | plain "
              f"{tm['plain_ms']:.5f} ms | bound {tm['bound_ms']:.7f} ms "
              f"({tm['bound_by']})")
        shapes[name][label] = {k: tm[k] for k in (
            "call_ms", "host_ms", "kernel_ms", "plain_ms", "bound_ms",
            "bound_by")}
    entries = []
    for name in fns:
        t = shapes[name]["serving"]
        entries.append(dict(
            name=name, route="cuda", source="gbrl_tpu_torch/csrc/predict.cu",
            replaces=REPLACES[name], launches=launches[name],
            max_abs_err=errs[name], ms=t["call_ms"], plain_ms=t["plain_ms"],
            bound_ms=t["bound_ms"], bound_by=t["bound_by"], library_ms=None,
            call_ms=t["call_ms"], host_ms=t["host_ms"],
            kernel_ms=t["kernel_ms"],
            shapes={k: v for k, v in shapes[name].items() if k != "serving"}))
    return entries


# ============================================================ api
# phase 17 serves full width (F, O, depth) with fewer trees than phase 4,
# so that the CPU port it is held against answers in a few seconds
API_ROWS = 1024         # observations per request
API_TREES, API_CAPACITY = 200, 256


def api_models(rng, policy: str, tmp: str):
    """A shared and a separate ActorCritic built on the CPU port at full
    width, their ensembles synthetic (API_TREES in API_CAPACITY), each
    written with ``save_learner``; returns the checkpoint paths."""
    from gbrl_tpu_torch import ActorCritic
    from gbrl_tpu_torch.ensemble import ensemble_from_numpy
    pol = dict(algo="SGD", init_lr=0.05, start_idx=0, stop_idx=O - 1)
    val = dict(algo="SGD", init_lr=0.1, start_idx=O - 1, stop_idx=O)
    paths = {}
    for shared in (True, False):
        model = ActorCritic(dict(max_depth=DEPTH, grow_policy=policy), F, O,
                            dict(pol), dict(val), shared_tree_struct=shared,
                            device="cpu")
        learners = ([model.learner] if shared else model.learner.learners)
        for lr, o in zip(learners, (O,) if shared else (O - 1, 1)):
            lr.set_feature_mapping(np.ones(F, bool))
            lr.ens = ensemble_from_numpy(synthetic_ensemble(
                rng, policy, capacity=API_CAPACITY, n_trees=API_TREES, o=o),
                device="cpu")
        paths[shared] = os.path.join(tmp, f"{policy}_{shared}")
        model.save_learner(paths[shared])
    return paths


def phase_api(dev, seed: int) -> dict:
    """Phase 17: the public names the port added last, on the card against
    the CPU port.  Per grow policy, a shared and a separate ActorCritic at
    full width (F = 16, O = 3, depth 4; 200 trees) written by the CPU port
    are loaded on the card: ``get_num_trees``; requests; the separate
    learner's ``predict`` (both models, each alone, a tree range);
    ``save_learner`` from the card, loaded back on the CPU and asked again;
    ``chunk_leaf_indices`` over every tree slot equal to the CPU's;
    ``tree_shap_device_one`` for one tree.  Every request gets fresh rows,
    so none is served from the learner's cache.  Launch counts are set to 0
    before and read after: each request launches its policy's leaf sum (K4
    greedy, K5 oblivious) once per learner it reaches, 11 per policy, and
    no fit kernel runs.  Returns the launch counts."""
    import torch
    from gbrl_tpu_torch import ActorCritic
    from gbrl_tpu_torch.config import TreeConfig
    from gbrl_tpu_torch.ensemble import ensemble_from_numpy
    from gbrl_tpu_torch.ops import kernels as K
    from gbrl_tpu_torch.ops.predict import chunk_leaf_indices
    from gbrl_tpu_torch.ops.shap_device import tree_shap_device_one
    print("[17 api]", flush=True)
    t_phase = time.perf_counter()
    rng = np.random.default_rng(seed + 17)

    def serve(card_fn, cpu_fn, *args, **kwargs):
        """card_fn and cpu_fn on the same fresh rows; the CPU's output is
        moved to the card."""
        obs = rng.normal(size=(API_ROWS, F)).astype(np.float32)
        a, b = card_fn(obs, *args, **kwargs), cpu_fn(obs, *args, **kwargs)
        if isinstance(b, tuple):
            return a, tuple(x.to(dev) for x in b)
        return a, b.to(dev)

    want = {name: 0 for name in PREDICT_KERNELS}
    K.reset_launch_counts()
    with tempfile.TemporaryDirectory() as tmp:
        for policy in ("greedy", "oblivious"):
            key = ("oblivious_leaf_sum" if policy == "oblivious"
                   else "weighted_leaf_sum")
            paths = api_models(rng, policy, tmp)
            for shared, path in paths.items():
                label = f"{policy} {'shared' if shared else 'separate'}"
                card = ActorCritic.load_learner(path, device="cuda")
                cpu = ActorCritic.load_learner(path, device="cpu")
                want_trees = API_TREES if shared else (API_TREES,
                                                       API_TREES)
                assert card.get_num_trees() == cpu.get_num_trees() == \
                    want_trees, (label, card.get_num_trees())
                # every card call gets rows of its own: a repeated host
                # input would be served from the learner's cache and
                # launch nothing
                for a, b, what in zip(*serve(card, cpu),
                                      ("policy", "value")):
                    assert a.device.type == "cuda"
                    check_close(f"{label} {what}", a, b)
                if not shared:
                    lr, lc = card.learner, cpu.learner
                    for a, b in zip(*serve(lr.predict, lc.predict)):
                        check_close(f"{label} predict", a, b)
                    for idx in (0, 1):
                        check_close(f"{label} predict model_idx={idx}",
                                    *serve(lr.predict, lc.predict,
                                           model_idx=idx))
                    check_close(f"{label} predict trees [50, 150)",
                                *serve(lr.predict, lc.predict, True, 50,
                                       150, model_idx=0))
                again = path + "_from_card"
                card.save_learner(again)
                back = ActorCritic.load_learner(again, device="cpu")
                assert back.get_num_trees() == want_trees
                for a, b, what in zip(*serve(card, back),
                                      ("policy", "value")):
                    check_close(f"{label} {what} after save_learner", a, b)
                # one leaf sum per learner a call reaches: the shared model
                # 2 calls x 1; the separate 2 calls x 2, the learner's
                # predict 2 + 1 + 1 + 1
                want[key] += 2 if shared else 9
            # leaf indices and one tree's SHAP from the greedy / oblivious
            # ensemble's arrays, on the card against the CPU
            arrs = synthetic_ensemble(rng, policy, capacity=API_CAPACITY,
                                      n_trees=API_TREES)
            arrs["counts"] = rng.integers(1, 100, arrs["counts"].shape
                                          ).astype(np.float32)
            ens = {d: ensemble_from_numpy(arrs, d) for d in ("cuda", "cpu")}
            X = rng.normal(size=(API_ROWS, F)).astype(np.float32)
            Xd = {"cuda": torch.from_numpy(X).to(dev),
                  "cpu": torch.from_numpy(X)}
            idx = {d: chunk_leaf_indices(
                e.feat, e.thr, e.cat_code, e.is_split, e.is_numeric, Xd[d],
                None, DEPTH) for d, e in ens.items()}
            assert idx["cuda"].device.type == "cuda"
            assert torch.equal(idx["cuda"].cpu(), idx["cpu"]), \
                f"{policy}: chunk_leaf_indices differ on the card"
            print(f"  {policy} chunk_leaf_indices [{API_ROWS} x "
                  f"{API_CAPACITY}] equal to the CPU's")
            cfg = TreeConfig(input_dim=F, output_dim=O, n_num_features=F,
                             max_depth=DEPTH, grow_policy=policy)
            t = 7
            phi = {d: tree_shap_device_one(
                cfg, e.feat[t], e.thr[t], e.cat_code[t], e.is_split[t],
                e.is_numeric[t], e.counts[t], e.leaf_values[t], Xd[d], None,
                F) for d, e in ens.items()}
            err = (phi["cuda"].cpu() - phi["cpu"]).abs().max().item()
            lim = SHAP_RTOL * phi["cpu"].abs().max().item() + SHAP_ATOL
            assert phi["cuda"].device.type == "cuda" and err <= lim, \
                f"{policy} tree_shap_device_one: {err} > {lim}"
            print(f"  {policy} tree_shap_device_one (tree {t}): max abs err "
                  f"{err:.3g} (limit {lim:.3g})")
    torch.cuda.synchronize()
    launches = dict(K.launch_counts)
    print(f"  launch counts over phase 17: {launches_of(launches)}")
    for name in PREDICT_KERNELS:
        assert launches[name] == want[name], \
            f"{name}: {launches[name]} launches in phase 17, {want[name]} " \
            "requests reached it"
    fits = {k: v for k, v in launches.items() if k not in PREDICT_KERNELS}
    assert not any(fits.values()), f"a fit kernel ran in phase 17: {fits}"
    print(f"  phase 17 took {time.perf_counter() - t_phase:.1f} s")
    return launches


# ============================================================ parallel
# phase 16: data-parallel training over torch.distributed, two ranks that
# share the one card.  (a) examples/multihost_ppo.py's width: per rank 8
# envs x 128 steps (2048 rows over both ranks), minibatches of 256, 4 epochs
# -> 32 trees a phase; F = 4, O = 3, depth 4, 64 bins, greedy, cosine, SGD
# lr 0.17 / 0.01; 3 iterations on each tree path.  (b) the supervised steps
# at the bench shape (N = 4096 over both ranks, F = 16, O = 3, depth 4, 256
# quantile bins, cosine), 20 train steps per grow policy then 2 boost steps.
# (c) the same steps through an NCCL group of one.
PAR_WORLD = 2
PAR_ENVS, PAR_STEPS, PAR_BATCH, PAR_EPOCHS = 8, 128, 256, 4
PAR_BINS, PAR_ITERS = 64, 3
PAR_ROWS = PAR_WORLD * PAR_ENVS * PAR_STEPS
PAR_TREES = PAR_EPOCHS * PAR_ROWS // PAR_BATCH
PAR_TIMED = 6           # timed update phases per rank and path (p50 / p90)
PAR_SUP_STEPS, PAR_SUP_BOOSTS = 20, 2
PAR_TIMEOUT = 400       # seconds the ranks may take together
# tests/test_parallel_rl.py:70-74 and tests/test_multihost.py:101-113
PAR_LEAF_TOL = dict(rtol=1e-5, atol=1e-6)
PAR_THR_TOL = dict(rtol=1e-6, atol=1e-7)
# a collective's row in a torch.profiler table
COLLECTIVE_KEYS = ("all_reduce", "allreduce", "all_gather", "allgather",
                   "broadcast", "gloo", "nccl")


def free_port() -> int:
    import socket
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def par_ppo_setup():
    """examples/multihost_ppo.py's trees, optimizers and PPO constants."""
    from gbrl_tpu_torch.config import TreeConfig
    from gbrl_tpu_torch.optimizers import OptimizerSpec
    cfg = TreeConfig(input_dim=4, output_dim=3, n_num_features=4,
                     max_depth=DEPTH, n_bins=PAR_BINS, grow_policy="greedy",
                     split_score_func="cosine")
    specs = (OptimizerSpec(algo="SGD", init_lr=0.17, start_idx=0, stop_idx=2),
             OptimizerSpec(algo="SGD", init_lr=0.01, start_idx=2, stop_idx=3))
    return cfg, specs, ppo_hyper()


def par_plan(seed: int, it: int):
    """The global minibatch plan of iteration ``it``, drawn from a seed
    every rank shares (examples/multihost_ppo.py)."""
    prng = np.random.default_rng(seed * 100_003 + it)
    U = PAR_EPOCHS * (PAR_ROWS // PAR_BATCH)
    mb_idx = np.zeros((U, PAR_BATCH), np.int64)
    u = 0
    for _ in range(PAR_EPOCHS):
        perm = prng.permutation(PAR_ROWS)
        for start in range(0, PAR_ROWS, PAR_BATCH):
            mb_idx[u] = perm[start:start + PAR_BATCH]
            u += 1
    return mb_idx, np.full(U, PAR_BATCH, np.int64)


def par_rollout(mirror, envs, obs, dones, rng, A: int = 2, gamma=0.99,
                lam=0.95):
    """One rollout of this rank's envs served by the host mirror, then GAE
    on the local slice (examples/multihost_ppo.py).  Returns the flat
    rollout (X, actions, log-probs, advantages, returns, valid) and the
    envs' next observations and done flags."""
    S, E = PAR_STEPS, envs.num_envs
    O_b = np.zeros((S, E, 4), np.float32)
    A_b = np.zeros((S, E), np.int64)
    R_b, D_b, V_b, LP_b = (np.zeros((S, E), np.float32) for _ in range(4))
    for t in range(S):
        preds = mirror.predict(obs.astype(np.float32))
        logits = preds[:, :A] - preds[:, :A].max(axis=1, keepdims=True)
        logp = logits - np.log(np.exp(logits).sum(1, keepdims=True))
        acts = (rng.random(E)[:, None] >= np.cumsum(np.exp(logp), axis=1)
                ).sum(1)
        np.clip(acts, 0, A - 1, out=acts)
        O_b[t], A_b[t], D_b[t], V_b[t] = obs, acts, dones, preds[:, A]
        LP_b[t] = np.take_along_axis(logp, acts[:, None], 1)[:, 0]
        obs, rew, term, trunc, _ = envs.step(acts)
        R_b[t] = rew
        dones = np.logical_or(term, trunc).astype(np.float32)
    nv = mirror.predict(obs.astype(np.float32))[:, A]
    nnt = 1.0 - dones
    adv = np.zeros_like(R_b)
    gae = np.zeros(E, np.float32)
    for t in reversed(range(S)):
        delta = R_b[t] + gamma * nv * nnt - V_b[t]
        gae = delta + gamma * lam * nnt * gae
        adv[t] = gae
        nv, nnt = V_b[t], 1.0 - D_b[t]
    flat = (O_b.reshape(-1, 4), A_b.reshape(-1), LP_b.reshape(-1),
            adv.reshape(-1), (adv + V_b).reshape(-1), 1.0 - D_b.reshape(-1))
    return flat, obs, dones


def ens_digest(arrs: dict) -> str:
    import hashlib
    h = hashlib.sha256()
    for k in sorted(arrs):
        h.update(np.ascontiguousarray(arrs[k]).tobytes())
    return h.hexdigest()


def phase_profile(fn) -> dict:
    """One torch.profiler window over ``fn``: device busy ms, the memcpy
    rows' device ms, and the collectives' host ms (the largest CPU total
    among rows named like a collective; gloo runs them on the host)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3

    def dev_us(e):
        return getattr(e, "self_device_time_total",
                       getattr(e, "self_cuda_time_total", 0.0))
    avgs = prof.key_averages()
    coll = [e for e in avgs if any(k in e.key.lower() for k in COLLECTIVE_KEYS)]
    return dict(
        wall_ms=wall, busy_ms=sum(dev_us(e) for e in avgs) / 1e3,
        memcpy_ms=sum(dev_us(e) for e in avgs if "memcpy" in e.key.lower())
        / 1e3,
        collective_host_ms=max((e.cpu_time_total for e in coll), default=0.0)
        / 1e3,
        collective_device_ms=sum(dev_us(e) for e in coll) / 1e3,
        collective_rows={e.key[:40]: e.count for e in coll})


def rank_ppo(mesh, seed: int, out: dict) -> dict:
    """Phase 16(a) on one rank: PAR_ITERS iterations of rollout (host
    mirror), GAE, global plan and ``hosts.host_ppo_update`` on each tree
    path; then PAR_TIMED timed update phases and one profiled.  Writes each
    iteration's rollout, the ensemble before it and after it into ``out``;
    returns the per-phase launch counts, syncs, collectives, digests and
    times."""
    import torch
    from types import SimpleNamespace
    from gbrl_tpu_torch.ensemble import (ensemble_to_numpy, ensure_capacity,
                                         init_ensemble)
    from gbrl_tpu_torch.ops import kernels as K
    from gbrl_tpu_torch.parallel import hosts
    from gbrl_tpu_torch.utils.host_mirror import HostMirror
    cfg, specs, hp = par_ppo_setup()
    fw = np.ones(4, np.float32)
    res = {}
    for path in ("level", "k6"):
        r = res[path] = dict(launches=[], syncs=[], collectives=[],
                             digests=[], times_ms=[])
        with tree_path(path == "k6"):
            ens = hosts.replicate(mesh, ensure_capacity(
                init_ensemble(cfg, 64, "cpu"), PAR_ITERS * PAR_TREES))
            shim = SimpleNamespace(cfg=cfg, specs=specs, ens=ens,
                                   _rl_host_n_trees=0)
            mirror = HostMirror(shim)
            envs = VecCartPole(PAR_ENVS)
            obs, _ = envs.reset(seed=seed + 100 * mesh.rank)
            dones = np.zeros(PAR_ENVS, np.float32)
            rng = np.random.default_rng(seed * 977 + mesh.rank)
            nt = 0
            for it in range(PAR_ITERS):
                flat, obs, dones = par_rollout(mirror, envs, obs, dones, rng)
                mb_idx, mb_n = par_plan(seed, it)
                key = f"{path}_{it}"
                for name, a in zip(("X", "act", "logp", "adv", "ret",
                                    "valid"), flat):
                    out[f"{key}_{name}"] = a
                out.update({f"{key}_pre_{k}": v
                            for k, v in ensemble_to_numpy(ens).items()})
                # the closure keeps this iteration's state: the timed and
                # profiled phases below repeat the last one
                pre, got, nt0 = ens, [], nt
                K.reset_launch_counts()
                c0 = mesh.collectives

                def update():
                    got.append(hosts.host_ppo_update(
                        cfg, hp, mesh, pre, flat[0], mb_idx, mb_n, flat[1],
                        flat[2], flat[3], flat[4], specs, fw,
                        valid_local=flat[5], n_trees0=nt0)[0])
                r["syncs"].append(sync_count(update))
                torch.cuda.synchronize()
                r["launches"].append(dict(K.launch_counts))
                r["collectives"].append(mesh.collectives - c0)
                ens = got[0]
                nt = nt0 + len(mb_n)
                post = ensemble_to_numpy(ens)
                r["digests"].append(ens_digest(post))
                out.update({f"{key}_post_{k}": v for k, v in post.items()})
                shim.ens, shim._rl_host_n_trees = ens, nt
                mirror.sync()
            for _ in range(PAR_TIMED):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                update()
                torch.cuda.synchronize()
                r["times_ms"].append((time.perf_counter() - t0) * 1e3)
            r["profile"] = phase_profile(update)
        r["updates"] = len(mb_n)
    return res


def rank_supervised(mesh, seed: int, out: dict) -> dict:
    """Phase 16(b) on one rank: ``hosts.host_train_step`` x PAR_SUP_STEPS
    then ``host_boost_step`` x PAR_SUP_BOOSTS per grow policy from this
    rank's half of the data; then K6 asked for with samples over both ranks
    must raise."""
    import torch
    from gbrl_tpu_torch.ensemble import ensemble_to_numpy, init_ensemble
    from gbrl_tpu_torch.ops import kernels as K
    from gbrl_tpu_torch.parallel import hosts
    X, y, g, specs = par_sup_data(seed)
    n = len(X) // mesh.world
    sl = slice(mesh.rank * n, (mesh.rank + 1) * n)
    fw = np.ones(F, np.float32)
    res = {}
    for policy in ("greedy", "oblivious"):
        cfg = fit_config(F, DEPTH, policy)
        r = res[policy] = dict(launches=[], syncs=[], times_ms=[])
        ens = hosts.replicate(mesh, init_ensemble(cfg, 32, "cpu"))
        losses = []
        for s in range(PAR_SUP_STEPS + PAR_SUP_BOOSTS):
            K.reset_launch_counts()
            got = []
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            if s < PAR_SUP_STEPS:
                got.append(hosts.host_train_step(cfg, mesh, ens, X[sl], y[sl],
                                                 fw, specs))
                ens, loss = got[0]
                losses.append(loss)
            else:
                ens = hosts.host_boost_step(cfg, mesh, ens, X[sl], g[sl], fw)
            torch.cuda.synchronize()
            r["times_ms"].append((time.perf_counter() - t0) * 1e3)
            r["launches"].append(dict(K.launch_counts))
        arrs = ensemble_to_numpy(ens)
        r["digest"] = ens_digest(arrs)
        r["losses"] = torch.stack(losses).cpu().tolist()
        out.update({f"sup_{policy}_{k}": v for k, v in arrs.items()})
        with tree_path(True):
            try:
                hosts.host_boost_step(cfg, mesh, ens, X[sl], g[sl], fw)
                r["k6_raised"] = ""
            except ValueError as e:
                r["k6_raised"] = str(e)
    return res


def par_sup_data(seed: int):
    """The supervised data of phase 16(b)-(c): N = 4096 normal observations,
    linear targets, random gradients; SGD lr 0.1 on every output."""
    from gbrl_tpu_torch.optimizers import OptimizerSpec
    rng = np.random.default_rng(seed + 16)
    X = rng.normal(size=(N, F)).astype(np.float32)
    W = rng.normal(size=(F, O)).astype(np.float32)
    y = (X @ W + 0.1 * rng.normal(size=(N, O))).astype(np.float32)
    g = rng.normal(size=(N, O)).astype(np.float32)
    return X, y, g, (OptimizerSpec(algo="SGD", init_lr=0.1, start_idx=0,
                                   stop_idx=O),)


def rank_worker(args) -> int:
    """One rank of phase 16 (``--rank``): joins the gloo group on the card,
    runs 16(a) and 16(b), writes rank<r>.npz / rank<r>.json into
    ``--out``."""
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke rank: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from gbrl_tpu_torch.parallel import hosts
    torch.set_num_threads(2)
    hosts.initialize(f"127.0.0.1:{args.port}", args.world, args.rank,
                     backend="gloo", device="cuda")
    mesh = hosts.global_mesh()
    assert (mesh.rank, mesh.world, mesh.backend) == (args.rank, args.world,
                                                     "gloo")
    out = {}
    res = dict(ppo=rank_ppo(mesh, args.seed, out),
               supervised=rank_supervised(mesh, args.seed, out))
    np.savez(os.path.join(args.out, f"rank{args.rank}.npz"), **out)
    with open(os.path.join(args.out, f"rank{args.rank}.json"), "w") as f:
        json.dump(res, f)
    hosts.shutdown()
    return 0


def spawn_ranks(seed: int, tmp: str) -> list:
    """Start PAR_WORLD rank processes of this script (subprocesses: the
    parent already holds a CUDA context), wait for all of them, and kill
    every one still running on a failure or past PAR_TIMEOUT.  Returns
    each rank's (json, npz)."""
    port = free_port()
    procs, logs = [], []
    try:
        for r in range(PAR_WORLD):
            logs.append(open(os.path.join(tmp, f"rank{r}.log"), "w"))
            procs.append(subprocess.Popen(
                [sys.executable, os.path.abspath(__file__), "--rank", str(r),
                 "--world", str(PAR_WORLD), "--port", str(port), "--out",
                 tmp, "--seed", str(seed)], stdout=logs[-1],
                stderr=subprocess.STDOUT))
        deadline = time.monotonic() + PAR_TIMEOUT
        for p in procs:
            p.wait(timeout=max(1.0, deadline - time.monotonic()))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        for f in logs:
            f.close()
    for r, p in enumerate(procs):
        with open(os.path.join(tmp, f"rank{r}.log")) as f:
            log = f.read()
        assert p.returncode == 0, f"rank {r} failed ({p.returncode}):\n" \
            + log[-4000:]
    res = []
    for r in range(PAR_WORLD):
        with open(os.path.join(tmp, f"rank{r}.json")) as f:
            res.append((json.load(f), dict(np.load(
                os.path.join(tmp, f"rank{r}.npz")))))
    return res


def assert_leaves_close(label: str, got: dict, want: dict, a: int, b: int,
                        thr_tol: dict) -> None:
    """Trees [a, b): structure equal, thresholds within ``thr_tol``, leaves
    within PAR_LEAF_TOL, elementwise."""
    for k in ("feat", "is_split"):
        assert np.array_equal(got[k][a:b], want[k][a:b]), f"{label}: {k}"
    np.testing.assert_allclose(got["thr"][a:b], want["thr"][a:b],
                               err_msg=f"{label}: thr", **thr_tol)
    np.testing.assert_allclose(got["leaf_values"][a:b],
                               want["leaf_values"][a:b],
                               err_msg=f"{label}: leaf values",
                               **PAR_LEAF_TOL)


def sub_dict(npz: dict, prefix: str) -> dict:
    return {k[len(prefix):]: v for k, v in npz.items() if k.startswith(prefix)}


def par_check_ppo(dev, seed: int, ranks: list) -> dict:
    """Phase 16(a)'s checks in the parent: both ranks' ensembles equal
    after every iteration; each iteration's trees against one process
    running ``ppo_update_loop`` on the card over both ranks' rollouts
    concatenated; launches per rank and phase; the single-process phase's
    p50 / p90 beside the ranks'.  Returns the launches per path and the
    last phase's inputs (the ensemble before it, the concatenated rollout
    on the card, the plan, the tree count)."""
    import torch
    from gbrl_tpu_torch.ensemble import ensemble_from_numpy, ensemble_to_numpy
    from gbrl_tpu_torch.rl import jit_update as JU
    cfg, specs, hp = par_ppo_setup()
    fw = torch.ones(4, device=dev)
    (r0, n0), (r1, n1) = ranks
    launches = {}
    for path in ("level", "k6"):
        k6 = path == "k6"
        a, b = r0["ppo"][path], r1["ppo"][path]
        assert a["digests"] == b["digests"], f"{path}: ranks' ensembles differ"
        U = a["updates"]
        assert U == PAR_TREES, U
        want = dict(bucketize=U, level_histogram=0 if k6 else DEPTH * U,
                    level_score=0 if k6 else DEPTH * U,
                    tree_build=U if k6 else 0, weighted_leaf_sum=1,
                    oblivious_leaf_sum=0)
        for r, res in enumerate((a, b)):
            for it, c in enumerate(res["launches"]):
                assert c == want, f"{path} rank {r} iteration {it}: {c}"
        launches[path] = want
        ref_times, syncs_ref = [], None
        for it in range(PAR_ITERS):
            key = f"{path}_{it}_"
            roll = [np.concatenate([n0[key + c], n1[key + c]])
                    for c in ("X", "act", "logp", "adv", "ret", "valid")]
            t = [torch.from_numpy(x).to(dev) for x in roll]
            mb_idx, mb_n = par_plan(seed, it)
            mbd = torch.from_numpy(mb_idx).to(dev)
            pre = ensemble_from_numpy(sub_dict(n0, key + "pre_"), "cuda")
            nt0 = it * U

            def single():
                return JU.ppo_update_loop(
                    cfg, hp, U, pre, t[0], mbd, mb_n.tolist(), t[1], t[2],
                    t[3], t[4], specs, fw, nt0, t[5])[0]
            # fits are recorded on plain calls: a recording waits for the
            # card, which a graph's capture cannot
            with tree_path(k6), recorded_fits(JU) as fits, plain_steps():
                ref = ensemble_to_numpy(single())
            with tree_path(k6):
                replayed = ensemble_to_numpy(single())
            for k in ref:
                assert np.array_equal(ref[k], replayed[k]), \
                    f"16a {path} iteration {it}: graph replay differs in {k}"
            post = sub_dict(n0, key + "post_")
            verdict = compare_phase(f"16a {path} iteration {it}", cfg, ref,
                                    post, fits, nt0, U)
            if verdict.startswith("all"):
                assert_leaves_close(f"16a {path} iteration {it}", post, ref,
                                    nt0, nt0 + U, dict(rtol=0, atol=0))
            print(f"  16a {path} path iteration {it}: ranks' ensembles "
                  f"bit-identical (sha256 {a['digests'][it][:12]}); "
                  f"against one process over both rollouts: {verdict}")
            if it == PAR_ITERS - 1:
                with tree_path(k6):
                    syncs_ref = sync_count(single)
                    for _ in range(PAR_TIMED):
                        torch.cuda.synchronize()
                        t0 = time.perf_counter()
                        single()
                        torch.cuda.synchronize()
                        ref_times.append((time.perf_counter() - t0) * 1e3)
        for r, res in enumerate((a, b)):
            p50, p90 = np.percentile(res["times_ms"], [50, 90])
            pr = res["profile"]
            print(f"  16a {path} rank {r}: update phase p50 {p50:.4f} ms p90 "
                  f"{p90:.4f} ms (n={len(res['times_ms'])}); host syncs "
                  f"{res['syncs']} (sync debug mode), collectives "
                  f"{res['collectives']} per phase; launches {res['launches'][0]}")
            print(f"    profiled phase: wall {pr['wall_ms']:.3f} ms, device "
                  f"busy {pr['busy_ms']:.3f} ms, memcpy {pr['memcpy_ms']:.3f}"
                  f" ms ({100 * pr['memcpy_ms'] / max(pr['busy_ms'], 1e-9):.1f}"
                  f"% of busy), collectives on the host "
                  f"{pr['collective_host_ms']:.3f} ms "
                  f"({pr['collective_host_ms'] / U:.4f} ms a minibatch), on "
                  f"the device {pr['collective_device_ms']:.3f} ms; rows "
                  f"{pr['collective_rows']}")
        p50, p90 = np.percentile(ref_times, [50, 90])
        print(f"  16a {path} one process on the card, both rollouts "
              f"({PAR_ROWS} rows): p50 {p50:.4f} ms p90 {p90:.4f} ms "
              f"(n={PAR_TIMED}); host syncs {syncs_ref} in ppo_update_loop")
    # the last level-path phase's inputs, for 16(c)
    return launches, (pre, t, mbd, mb_n, nt0)


def par_single_train(cfg, mesh, X, y, g, specs, dev, record: bool = False):
    """One process's boosting sequence on the card over all N rows: 20
    predict -> MultiRMSE -> boost steps then 2 boost steps, through
    ``sharded_train_step`` / ``sharded_boost_step`` when ``mesh`` is given,
    else through ``ops.boosting`` directly.  Returns (ensemble, losses,
    recorded fit inputs)."""
    import torch
    from gbrl_tpu_torch.ensemble import init_ensemble
    from gbrl_tpu_torch.ops import boosting as BO
    from gbrl_tpu_torch.ops.loss import multirmse_grads
    from gbrl_tpu_torch.parallel import sharded
    Xt, yt, gt = (torch.from_numpy(a).to(dev) for a in (X, y, g))
    fw = torch.ones(F, device=dev)
    w = torch.ones(len(X), device=dev)
    ens = init_ensemble(cfg, 32, "cuda")
    losses = []
    rec = recorded_fits(BO) if record else contextlib.nullcontext([])
    with rec as fits:
        for s in range(PAR_SUP_STEPS + PAR_SUP_BOOSTS):
            if s >= PAR_SUP_STEPS:
                ens = (BO.boost_step(cfg, ens, Xt, gt, fw) if mesh is None
                       else sharded.sharded_boost_step(cfg, mesh, ens, Xt,
                                                       gt, fw))
            elif mesh is None:
                preds = BO.predict_sgd(cfg, ens, Xt, specs, 0, ens.n_trees)
                grads, loss = multirmse_grads(preds, yt, w)
                ens = BO.boost_step(cfg, ens, Xt, grads, fw)
                losses.append(loss)
            else:
                ens, loss = sharded.sharded_train_step(cfg, mesh, ens, Xt, yt,
                                                       fw, specs)
                losses.append(loss)
    return ens, torch.stack(losses), fits


def par_check_supervised(dev, seed: int, ranks: list) -> dict:
    """Phase 16(b)'s checks in the parent: both ranks equal; launches per
    step; K6 raised; the ranks' trees and losses against one process's
    boost_step sequence on the card.  Returns the launches per step."""
    from gbrl_tpu_torch.ensemble import ensemble_to_numpy
    X, y, g, specs = par_sup_data(seed)
    (r0, n0), (r1, n1) = ranks
    launches = {}
    for policy in ("greedy", "oblivious"):
        cfg = fit_config(F, DEPTH, policy)
        a, b = r0["supervised"][policy], r1["supervised"][policy]
        assert a["digest"] == b["digest"], f"16b {policy}: ranks differ"
        assert a["losses"] == b["losses"], f"16b {policy}: losses differ"
        pk = "oblivious_leaf_sum" if policy == "oblivious" else \
            "weighted_leaf_sum"
        for r, res in enumerate((a, b)):
            assert "whole-tree path (K6)" in res["k6_raised"], \
                f"16b {policy} rank {r}: K6 with sharded samples did not raise"
            for s, c in enumerate(res["launches"]):
                step = s < PAR_SUP_STEPS
                want = dict(bucketize=1, level_histogram=DEPTH,
                            level_score=DEPTH, tree_build=0,
                            weighted_leaf_sum=int(step and pk ==
                                                  "weighted_leaf_sum"),
                            oblivious_leaf_sum=int(step and pk ==
                                                   "oblivious_leaf_sum"))
                assert c == want, f"16b {policy} rank {r} step {s}: {c}"
        launches[policy] = a["launches"][0]
        ref, losses, fits = par_single_train(cfg, None, X, y, g, specs, dev,
                                             record=True)
        ref = ensemble_to_numpy(ref)
        got = sub_dict(n0, f"sup_{policy}_")
        n = PAR_SUP_STEPS + PAR_SUP_BOOSTS
        verdict = compare_phase(f"16b {policy}", cfg, ref, got, fits, 0, n)
        if verdict.startswith("all"):
            assert_leaves_close(f"16b {policy}", got, ref, 0, n, PAR_THR_TOL)
            np.testing.assert_allclose(a["losses"], losses.cpu().numpy(),
                                       rtol=1e-5, atol=1e-6)
        for r, res in enumerate((a, b)):
            ts = res["times_ms"][2:PAR_SUP_STEPS]
            p50, p90 = np.percentile(ts, [50, 90])
            print(f"  16b {policy} rank {r}: host_train_step p50 {p50:.4f} ms "
                  f"p90 {p90:.4f} ms (n={len(ts)}); launches a step "
                  f"{res['launches'][0]}")
        print(f"  16b {policy}: ranks bit-identical, K6 raised on both; "
              f"against one process's boost_step sequence: {verdict}; "
              f"losses {a['losses'][0]:.5f} -> {a['losses'][-1]:.5f}")
    return launches


def par_nccl_one(dev, seed: int, ppo_args) -> dict:
    """Phase 16(c): the supervised steps and the last PPO phase of 16(a)
    through an NCCL group of one, bit-equal to the single-process card
    path, with 0 host syncs in a step and in ``sharded_ppo_update``.
    Returns the launches per train step."""
    import torch
    import torch.distributed as dist
    from gbrl_tpu_torch.ensemble import ensemble_to_numpy
    from gbrl_tpu_torch.ops import kernels as K
    from gbrl_tpu_torch.parallel import sharded, sharded_rl
    from gbrl_tpu_torch.rl import jit_update as JU
    X, y, g, specs = par_sup_data(seed)
    dist.init_process_group("nccl", init_method=f"tcp://127.0.0.1:"
                            f"{free_port()}", world_size=1, rank=0)
    try:
        mesh = sharded.make_mesh(device=dev)
        assert (mesh.world, mesh.backend) == (1, "nccl")
        launches = {}
        for policy in ("greedy", "oblivious"):
            cfg = fit_config(F, DEPTH, policy)
            a, la, _ = par_single_train(cfg, mesh, X, y, g, specs, dev)
            b, lb, _ = par_single_train(cfg, None, X, y, g, specs, dev)
            xa, xb = ensemble_to_numpy(a), ensemble_to_numpy(b)
            for k in xa:
                assert np.array_equal(xa[k], xb[k], equal_nan=True), \
                    f"16c {policy}: {k} differs from the single-process path"
            assert torch.equal(la, lb), f"16c {policy}: losses differ"
            Xt, yt = (torch.from_numpy(v).to(dev) for v in (X, y))
            fw = torch.ones(F, device=dev)
            K.reset_launch_counts()
            c0 = mesh.collectives
            syncs = sync_count(lambda: sharded.sharded_train_step(
                cfg, mesh, a, Xt, yt, fw, specs))
            torch.cuda.synchronize()
            launches[policy] = dict(K.launch_counts)
            assert syncs == 0, f"16c {policy}: {syncs} host syncs in a step"
            print(f"  16c {policy}: NCCL group of one, {PAR_SUP_STEPS} train "
                  f"+ {PAR_SUP_BOOSTS} boost steps bit-equal to the "
                  f"single-process card path (every field and loss); one "
                  f"step: {syncs} host syncs, {mesh.collectives - c0} "
                  f"collectives, launches {launches[policy]}")
        pcfg, pspecs, hp = par_ppo_setup()
        pre, t, mbd, mb_n, nt0 = ppo_args
        fw = torch.ones(4, device=dev)

        def ppo(fn, *a):
            return fn(pcfg, hp, *a)[0]
        a = ensemble_to_numpy(ppo(
            sharded_rl.sharded_ppo_update, mesh, pre, t[0], mbd, mb_n, t[1],
            t[2], t[3], t[4], pspecs, fw, t[5], nt0))
        b = ensemble_to_numpy(ppo(
            JU.ppo_update_loop, len(mb_n), pre, t[0], mbd, mb_n.tolist(),
            t[1], t[2], t[3], t[4], pspecs, fw, nt0, t[5]))
        for k in a:
            assert np.array_equal(a[k], b[k], equal_nan=True), \
                f"16c PPO: {k} differs from ppo_update_loop"
        c0 = mesh.collectives
        syncs = sync_count(lambda: sharded_rl.sharded_ppo_update(
            pcfg, hp, mesh, pre, t[0], mbd, mb_n, t[1], t[2], t[3], t[4],
            pspecs, fw, t[5], nt0))
        assert syncs == 0, f"16c PPO: {syncs} host syncs in the phase"
        print(f"  16c PPO: sharded_ppo_update over the NCCL group of one "
              f"({len(mb_n)} trees, level path) bit-equal to "
              f"ppo_update_loop; {syncs} host syncs, "
              f"{mesh.collectives - c0} collectives")
    finally:
        dist.destroy_process_group()
    return launches


def phase_parallel(dev, seed: int, smi: str) -> dict:
    """Phase 16: data-parallel training over torch.distributed.  Returns
    the launches per kernel: per rank and PPO phase on each path, per
    supervised step per policy (gloo ranks and the NCCL group of one)."""
    print(f"[16 parallel] {smi}", flush=True)
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        ranks = spawn_ranks(seed, tmp)
    print(f"  {PAR_WORLD} gloo ranks on the card (CUDA tensors) ran 16a-16b "
          f"in {time.perf_counter() - t0:.1f} s, spawn included", flush=True)
    ppo, ppo_args = par_check_ppo(dev, seed, ranks)
    sup = par_check_supervised(dev, seed, ranks)
    nccl = par_nccl_one(dev, seed, ppo_args)
    print(f"  phase 16 took {time.perf_counter() - t0:.1f} s", flush=True)
    return {"ppo_" + k: v for k, v in ppo.items()} | {
        "train_" + k: v for k, v in sup.items()} | {
        "nccl_one_" + k: v for k, v in nccl.items()}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    # one rank of phase 16 (the script starts these itself)
    ap.add_argument("--rank", type=int, help=argparse.SUPPRESS)
    ap.add_argument("--world", type=int, help=argparse.SUPPRESS)
    ap.add_argument("--port", type=int, help=argparse.SUPPRESS)
    ap.add_argument("--out", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.rank is not None:
        return rank_worker(args)

    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this check runs only on a GPU",
              file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from gbrl_tpu_torch import ActorCritic, SharedActorCriticLearner
    from gbrl_tpu_torch.config import TreeConfig
    from gbrl_tpu_torch.ensemble import ensemble_from_numpy
    from gbrl_tpu_torch.ops import kernels as K
    from gbrl_tpu_torch.ops.predict import weighted_leaf_sum

    rng = np.random.default_rng(args.seed)
    dev = torch.device("cuda")

    # ---------------------------------------------------------- 1 device
    smi = smi_line()
    print(f"[1 device] {smi} | {torch.cuda.get_device_name(0)} | "
          f"torch {torch.__version__} CUDA {torch.version.cuda}", flush=True)

    # ----------------------------------------------------------- 2 build
    t0 = time.perf_counter()
    lib_path = K.build_library()
    K._library()
    print(f"[2 build] {lib_path} in {time.perf_counter() - t0:.2f} s",
          flush=True)

    # ---------------------------------------------------------- 3 parity
    print("[3 parity]", flush=True)
    kfn = {"weighted_leaf_sum": (K.weighted_leaf_sum_cuda,
                                 K.weighted_leaf_sum_plain),
           "oblivious_leaf_sum": (K.oblivious_leaf_sum_cuda,
                                  K.oblivious_leaf_sum_plain)}
    kernel_args, max_err = {}, {}
    ens_arrs = {p: synthetic_ensemble(rng, p) for p in ("greedy", "oblivious")}
    for policy, arrs in ens_arrs.items():
        X = observations(rng, arrs)
        X[-3:] = np.nan                                    # NaN goes left
        t = [torch.from_numpy(np.ascontiguousarray(a)).to(dev) for a in
             (X, arrs["feat"], arrs["thr"], arrs["is_split"],
              arrs["leaf_values"])]
        cd = torch.from_numpy(rng.uniform(0.01, 0.1, size=(CAPACITY, O))
                              .astype(np.float32)).to(dev)
        w = t[4] * cd[:, None, :]          # pre-scaled: the same f32 product
        names = (["weighted_leaf_sum", "oblivious_leaf_sum"]
                 if policy == "oblivious" else ["weighted_leaf_sum"])
        for n, nt in ((N, N_TREES), (1000, 0), (1000, 1), (1000, 129)):
            args_nt = [t[0][:n].contiguous()] + t[1:]
            ntd = torch.tensor(nt, dtype=torch.int32, device=dev)
            outs = {}
            for name in names:
                fast, plain = kfn[name]
                outs[name] = fast(*args_nt, DEPTH, ntd, cd)
                again = fast(*args_nt, DEPTH, ntd, cd)
                pre = fast(*args_nt[:4], w, DEPTH, ntd)
                torch.cuda.synchronize()
                assert torch.equal(outs[name], again), \
                    f"{name}: two launches differ at N={n} n_trees={nt}"
                assert torch.equal(outs[name], pre), \
                    f"{name}: coefficient path != pre-scaled at n_trees={nt}"
                err = check_close(f"{policy} {name} N={n} n_trees={nt}",
                                  outs[name], plain(*args_nt, DEPTH, nt, cd))
                if nt == 0:
                    assert torch.equal(outs[name],
                                       torch.zeros_like(outs[name]))
                if n == N and nt == N_TREES:
                    max_err[name] = max(max_err.get(name, 0.0), err)
                    kernel_args[(name, policy)] = tuple(args_nt) + (
                        DEPTH, ntd, cd)
            if policy == "oblivious":
                assert torch.equal(outs["oblivious_leaf_sum"],
                                   outs["weighted_leaf_sum"]), \
                    f"K5 != K4 bitwise at N={n} n_trees={nt}"
                print(f"  K5 == K4 bitwise at N={n} n_trees={nt}")
        print(f"  {policy}: the same bits on two launches and with the "
              f"coefficients apart as pre-scaled, at every n_trees")

    # wide, deep and wide-output numeric ensembles go through ops.predict's
    # dispatch to the kernels (one launch each), held against the same call
    # on CPU tensors (plain version)
    for policy in ("greedy", "oblivious"):
        key = ("oblivious_leaf_sum" if policy == "oblivious"
               else "weighted_leaf_sum")
        for f, depth, o in DISPATCH_SHAPES:
            arrs = synthetic_ensemble(rng, policy, f, depth,
                                      DISPATCH_CAPACITY, DISPATCH_TREES, o)
            cfg = TreeConfig(input_dim=f, output_dim=o, n_num_features=f,
                             max_depth=depth, grow_policy=policy)
            X = torch.from_numpy(observations(rng, arrs, N, f))
            coeff = torch.from_numpy((rng.normal(size=(DISPATCH_CAPACITY, o))
                                      * (np.arange(DISPATCH_CAPACITY)
                                         < DISPATCH_TREES)[:, None])
                                     .astype(np.float32))
            before = K.launch_counts[key]
            got = weighted_leaf_sum(cfg, ensemble_from_numpy(arrs, "cuda"),
                                    X.to(dev), coeff.to(dev))
            torch.cuda.synchronize()
            assert K.launch_counts[key] == before + 1, \
                f"{policy} F={f} depth={depth} O={o}: {key} not launched once"
            want = weighted_leaf_sum(cfg, ensemble_from_numpy(arrs, "cpu"),
                                     X, coeff)
            staged = K._predict_plan(N, f, DISPATCH_CAPACITY, depth, o,
                                     policy == "oblivious").staged
            check_close(f"{policy} dispatch F={f} depth={depth} O={o} "
                        f"n_trees={DISPATCH_TREES} "
                        f"({'staged' if staged else 'global'} route)",
                        got, want.to(dev))

    # --------------------------------------------------------- 4 serving
    print("[4 serving]", flush=True)
    pol_sgd = dict(algo="SGD", init_lr=0.05, start_idx=0, stop_idx=O - 1)
    pol_adam = dict(algo="Adam", init_lr=0.01, start_idx=0, stop_idx=O - 1)
    val = dict(algo="SGD", scheduler="Linear", init_lr=0.1, stop_lr=0.01,
               T=2000, start_idx=O - 1, stop_idx=O)
    cases = [("greedy", pol_sgd), ("oblivious", pol_sgd), ("greedy", pol_adam)]
    obs = [observations(rng, ens_arrs["greedy"]) for _ in range(3)]
    models = {}
    K.reset_launch_counts()
    with tempfile.TemporaryDirectory() as tmp:
        for policy, pol in cases:
            label = f"{policy}/{pol['algo']}"
            before = dict(K.launch_counts)
            saver = SharedActorCriticLearner(
                F, O, dict(max_depth=DEPTH, grow_policy=policy), pol, val,
                device="cpu")
            saver.reset()
            saver.set_feature_mapping(np.ones(F, bool))
            saver.ens = ensemble_from_numpy(ens_arrs[policy], device="cpu")
            path = os.path.join(tmp, label.replace("/", "_"))
            saver.save(path)
            model = ActorCritic.load_learner(path, device="cuda")
            ref = ActorCritic.load_learner(path, device="cpu")
            assert model.get_num_trees() == N_TREES

            theta, value = model(obs[0])
            theta_c, value_c = ref(obs[0])
            assert theta.device.type == "cuda" and value.device.type == "cuda"
            assert theta.shape == (N, O - 1) and value.shape == (N,)
            check_close(f"{label} policy", theta, theta_c.to(dev))
            check_close(f"{label} value", value, value_c.to(dev))
            check_close(f"{label} predict_policy",
                        model.predict_policy(obs[1]),
                        ref.predict_policy(obs[1]).to(dev))
            check_close(f"{label} predict_values",
                        model.predict_values(obs[1]),
                        ref.predict_values(obs[1]).to(dev))
            mid = dict(K.launch_counts)
            again = model.predict_values(obs[1].copy())
            if pol["algo"] == "SGD":        # the cache serves repeated input
                assert K.launch_counts == mid, "repeated request relaunched"
            check_close(f"{label} repeated request", again,
                        ref.predict_values(obs[1]).to(dev))
            fut = model.learner.predict_async(obs[2])
            assert fut.device.type == "cuda" and fut.shape == (N, O)
            check_close(f"{label} predict_async", fut,
                        ref.learner.predict_async(obs[2]).to(dev))
            key = ("oblivious_leaf_sum" if policy == "oblivious"
                   else "weighted_leaf_sum")
            assert K.launch_counts[key] > before[key], f"{label}: {key} idle"
            models[label] = model
    torch.cuda.synchronize()
    launches = dict(K.launch_counts)
    print(f"  launch counts over the serving phase: {launches}")
    for name in PREDICT_KERNELS:
        assert launches[name] > 0, f"{name} was not launched on the serving path"

    # ----------------------------------------------------------- 5 times
    print("[5 times]", flush=True)
    obs_dev = torch.from_numpy(obs[0]).to(dev)
    for label, model in models.items():
        i = [0]

        def fresh_request():
            i[0] += 1
            model(obs[i[0] % 2])            # alternating inputs: cache misses
        print(f"  request latency {label} [N={N} x F={F}, {N_TREES} trees]")
        print(f"    host obs   {host_ms(fresh_request, REQUESTS)}")
        print(f"    cached     {host_ms(lambda: model(obs[0]), REQUESTS)}")
        print(f"    device obs {host_ms(lambda: model(obs_dev), REQUESTS)}")
        profile_requests(fresh_request)
    kernels = phase_predict_times(rng, dev, kernel_args, launches, max_err)

    fit_args, fit_err = phase_fit_parity(rng, dev)
    fit_launches = phase_training(rng, dev)
    kernels += phase_fit_times(rng, dev, fit_args, fit_err, fit_launches)
    tree_args, tree_err = phase_tree_parity(rng, dev)
    ppo = phase_ppo(rng, dev, args.seed)
    phase_a2c(rng, dev, args.seed)
    kernels.append(phase_rl_times(rng, dev, ppo, tree_args, tree_err))
    # the continuous-control paths: each kernel's times at their shapes and
    # its launches per AWR update phase (both tree paths) and per SAC step
    for label, ph in (("awr", phase_awr(dev, args.seed, smi)),
                      ("sac", phase_sac(dev, args.seed, smi))):
        for e in kernels:
            if e["name"] in ph["times"]:
                e[f"{label}_shape"] = ph["times"][e["name"]]
            e[f"{label}_launches"] = {path: c[e["name"]]
                                      for path, c in ph["launches"].items()}
    # explaining and exporting ensembles grown on the card: K1-K3 grow
    # them, K4 / K5 give the predictions they are held against
    explain = phase_explain(dev, args.seed, smi)
    for e in kernels:
        e["explain_launches"] = explain[e["name"]]
    # data-parallel training: two gloo ranks on the card, an NCCL group of
    # one; launches per rank and PPO phase, per supervised step
    par = phase_parallel(dev, args.seed, smi)
    for e in kernels:
        e["parallel_launches"] = {k: c[e["name"]] for k, c in par.items()}
    # the public names the port added last, against the CPU port
    api = phase_api(dev, args.seed)
    for e in kernels:
        e["api_launches"] = api[e["name"]]

    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
