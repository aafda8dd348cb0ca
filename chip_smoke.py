#!/usr/bin/env python3
"""Drive gbrl_tpu_torch's serving path on one NVIDIA GPU and check it.

    python3 chip_smoke.py [--seed 0]

The serving path: load a saved shared actor-critic ensemble with
``ActorCritic.load_learner(path, device="cuda")`` and answer predict
requests, through the hand-written CUDA predict kernels K4 (greedy) and K5
(oblivious) in ``gbrl_tpu_torch/csrc/predict.cu``.  Full width is the PPO
shared actor-critic shape: F = 16 numeric features, O = 3 outputs (2 policy
+ 1 value), depth 4, batches of N = 4096 observations, 1600 trees in a
capacity of 2048.  Ensembles are synthetic, made with numpy from ``--seed``.

Phases (any failure raises; the script then exits nonzero):
  1 device   the card's name, power limit and CUDA version;
  2 build    nvcc builds the kernels from the sources in the checkout;
  3 parity   K4 and K5 against their plain PyTorch versions at full width
             (ties x == thr, NaN rows, pass-through nodes, stale weights
             beyond n_trees), K5 bit-equal to K4 on oblivious ensembles,
             the edge cases N = 1000, n_trees in {0, 1, 129}, and
             ``ops.predict.weighted_leaf_sum`` on wide (F = 300) and deep
             (depth 8) numeric ensembles, which must reach the kernels;
  4 serving  greedy, oblivious and Adam checkpoints saved by the port,
             loaded on the card, requests answered and held against the
             same checkpoint loaded on the CPU; launch counts set to 0
             before and read after: K4 and K5 must have run;
  5 times    request latency (host clock, synchronized) and kernel times
             (CUDA events) beside the plain versions and the bound.

Without a CUDA device it exits nonzero before printing any result.  It
prints, before the last line, the nvidia-smi name/power-limit line and one
JSON line describing each kernel; the last line is the ok/device JSON.
"""
import argparse
import json
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
# wide and deep numeric shapes (F, depth) that ops.predict must send to the
# kernels: the TPU's VMEM guard (at most 256 features, depth 6) is not theirs
DISPATCH_SHAPES = ((300, 4), (16, 8))
DISPATCH_CAPACITY, DISPATCH_TREES = 512, 400
REPLACES = {"weighted_leaf_sum": "gbrl_tpu/ops/pallas_kernels.py:723",
            "oblivious_leaf_sum": "gbrl_tpu/ops/pallas_kernels.py:851"}


def smi_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True)
    return out.stdout.strip().splitlines()[0]


def synthetic_ensemble(rng, policy: str, f: int = F, depth: int = DEPTH,
                       capacity: int = CAPACITY,
                       n_trees: int = N_TREES) -> dict:
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
        leaf_values=rng.normal(size=(capacity, L, O)).astype(np.float32),
        counts=np.zeros((capacity, 2 * L - 1), np.float32),
        depths=np.full((capacity,), depth, np.int32),
        bias=rng.normal(size=O).astype(np.float32),
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


def profile_requests(fn, n: int = 20) -> None:
    """One torch.profiler window over ``n`` requests: the device's busy
    share of the window and the operators with the most device time."""
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
    print(f"  profile over {n} requests: wall {wall_us / n:.1f} us/request, "
          f"device busy {busy / n:.1f} us/request "
          f"({100 * busy / wall_us:.1f}% of the window)")
    for e in avgs[:8]:
        if dev_us(e) > 0:
            print(f"    {e.key[:60]:60s} calls {e.count:5d} "
                  f"device {dev_us(e) / n:8.2f} us/request")


def bound_ms(name: str, n: int, nt: int) -> tuple:
    """Least time for the work on an H100 SXM: bytes each input read once
    and the output written once, over HBM bandwidth, against compares and
    adds (depth + O per sample and live tree, FLOPS_PER_INSTR each) over
    the f32 peak."""
    IN, L = (1 << DEPTH) - 1, 1 << DEPTH
    nodes = IN if name == "weighted_leaf_sum" else DEPTH
    nbytes = n * F * 4 + nt * nodes * 9 + nt * L * O * 4 + n * O * 4 + 4
    ops = n * nt * (DEPTH + O) * FLOPS_PER_INSTR
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / F32_OPS_PER_S
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def check_close(what: str, got, want) -> float:
    import torch
    assert got.shape == want.shape, (what, got.shape, want.shape)
    assert torch.isfinite(got).all(), f"{what}: non-finite output"
    err = (got.float() - want.float()).abs().max().item() if got.numel() else 0.0
    lim = RTOL * (want.abs().max().item() if want.numel() else 0.0) + ATOL
    assert err <= lim, f"{what}: max abs err {err} > {lim}"
    print(f"  {what}: max abs err {err:.3g} (limit {lim:.3g})")
    return err


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()

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
        scale = rng.uniform(0.01, 0.1, size=(CAPACITY, 1, O))
        w = (arrs["leaf_values"] * scale).astype(np.float32)
        t = [torch.from_numpy(np.ascontiguousarray(a)).to(dev) for a in
             (X, arrs["feat"], arrs["thr"], arrs["is_split"], w)]
        names = (["weighted_leaf_sum", "oblivious_leaf_sum"]
                 if policy == "oblivious" else ["weighted_leaf_sum"])
        for n, nt in ((N, N_TREES), (1000, 0), (1000, 1), (1000, 129)):
            args_nt = [t[0][:n].contiguous()] + t[1:]
            ntd = torch.tensor(nt, dtype=torch.int32, device=dev)
            outs = {}
            for name in names:
                fast, plain = kfn[name]
                outs[name] = fast(*args_nt, DEPTH, ntd)
                torch.cuda.synchronize()
                err = check_close(f"{policy} {name} N={n} n_trees={nt}",
                                  outs[name], plain(*args_nt, DEPTH, nt))
                if nt == 0:
                    assert torch.equal(outs[name],
                                       torch.zeros_like(outs[name]))
                if n == N and nt == N_TREES:
                    max_err[name] = max(max_err.get(name, 0.0), err)
                    kernel_args[(name, policy)] = (args_nt, ntd)
            if policy == "oblivious":
                assert torch.equal(outs["oblivious_leaf_sum"],
                                   outs["weighted_leaf_sum"]), \
                    f"K5 != K4 bitwise at N={n} n_trees={nt}"
                print(f"  K5 == K4 bitwise at N={n} n_trees={nt}")

    # wide and deep numeric ensembles go through ops.predict's dispatch to
    # the kernels, held against the same call on CPU tensors (plain version)
    for policy in ("greedy", "oblivious"):
        key = ("oblivious_leaf_sum" if policy == "oblivious"
               else "weighted_leaf_sum")
        for f, depth in DISPATCH_SHAPES:
            arrs = synthetic_ensemble(rng, policy, f, depth,
                                      DISPATCH_CAPACITY, DISPATCH_TREES)
            cfg = TreeConfig(input_dim=f, output_dim=O, n_num_features=f,
                             max_depth=depth, grow_policy=policy)
            X = torch.from_numpy(observations(rng, arrs, N, f))
            coeff = torch.from_numpy((rng.normal(size=(DISPATCH_CAPACITY, O))
                                      * (np.arange(DISPATCH_CAPACITY)
                                         < DISPATCH_TREES)[:, None])
                                     .astype(np.float32))
            before = K.launch_counts[key]
            got = weighted_leaf_sum(cfg, ensemble_from_numpy(arrs, "cuda"),
                                    X.to(dev), coeff.to(dev))
            torch.cuda.synchronize()
            assert K.launch_counts[key] == before + 1, \
                f"{policy} F={f} depth={depth}: {key} not launched"
            want = weighted_leaf_sum(cfg, ensemble_from_numpy(arrs, "cpu"),
                                     X, coeff)
            check_close(f"{policy} dispatch F={f} depth={depth} "
                        f"n_trees={DISPATCH_TREES}", got, want.to(dev))

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
    for name, count in launches.items():
        assert count > 0, f"{name} was not launched on the serving path"

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
    kernels = []
    for (name, policy), (kargs, ntd) in kernel_args.items():
        if name == "weighted_leaf_sum" and policy == "oblivious":
            continue                         # K4 is timed on greedy trees
        fast, plain = kfn[name]
        ms = cuda_ms(lambda: fast(*kargs, DEPTH, ntd), KERNEL_REPS)
        plain_ms = cuda_ms(lambda: plain(*kargs, DEPTH, N_TREES), KERNEL_REPS)
        bms, bound_by = bound_ms(name, N, N_TREES)
        print(f"  {name} ({policy}): {ms:.5f} ms | plain {plain_ms:.5f} ms | "
              f"bound {bms:.6f} ms ({bound_by})")
        kernels.append(dict(
            name=name, route="cuda", source="gbrl_tpu_torch/csrc/predict.cu",
            replaces=REPLACES[name], launches=launches[name],
            max_abs_err=max_err[name], ms=ms, plain_ms=plain_ms,
            bound_ms=bms, bound_by=bound_by, library_ms=None))

    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
