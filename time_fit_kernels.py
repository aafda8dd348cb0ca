#!/usr/bin/env python3
"""Time K1 (bucketize), K2 (level histogram), K3 (level split score), K6
(whole tree), K4 and K5 (ensemble predict) of one checkout of
gbrl_tpu_torch on one NVIDIA GPU: the fit kernels at the bench shape
(N = 4096, F = 16) and the PPO minibatch shape (N = 512, F = 4), K1 and K2
beside torch.searchsorted and index_add_ on the same inputs; K4 and K5 at
the serving shape (N = 4096, 1600 of 2048 trees, F = 16) and at
``chip_smoke.PREDICT_TIMES``' PPO-rollout and A2C shapes, both the kernel
wrapper and the whole ``ops.predict.weighted_leaf_sum`` call.

    python3 time_fit_kernels.py [--root DIR] [--seed 0]

``--root`` names the checkout whose ``gbrl_tpu_torch`` is timed (default:
this one), so two versions can be compared on one card in one go:
run parent, change, change, parent.  Inputs, timing and bounds are
``chip_smoke.py``'s (``fit_time_inputs``, ``fit_kernel_times``): call_ms is
the median single call between CUDA events, kernel_ms the profiler's
device time per call; K2's and K3's numbers are one tree's four levels
summed; K6 fits one greedy cosine tree of depth 4 on ``tree_inputs``.  A
checkout whose K4 / K5 wrappers take no ``coeff`` (before the fused
product) is given the pre-scaled weights, made outside the timed call;
``weighted_leaf_sum`` times what a request pays in either version.  Prints
one JSON line per kernel and shape."""
import argparse
import importlib.util
import inspect
import json
import os
import sys

import numpy as np


def main() -> int:
    here = os.path.dirname(os.path.abspath(__file__))
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=here)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("time_fit_kernels: no CUDA device", file=sys.stderr)
        return 1
    spec = importlib.util.spec_from_file_location(
        "chip_smoke_helpers", os.path.join(here, "chip_smoke.py"))
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    sys.path.insert(0, os.path.abspath(args.root))
    from gbrl_tpu_torch.ops import kernels as K
    assert K.__file__.startswith(os.path.abspath(args.root)), K.__file__
    rng = np.random.default_rng(args.seed)
    dev = torch.device("cuda")
    print(cs.smi_line())
    for shape, (n, f) in (("bench", (cs.N, cs.F)),
                          ("ppo", (cs.PPO_N, cs.PPO_F))):
        inp = cs.fit_time_inputs(K, rng, dev, n, f)
        inp["level_score"] = cs.level_score_inputs(K, dev,
                                                   inp["level_histogram"])
        inp["tree_build"] = [cs.tree_inputs(rng, dev, n, f, False, False)
                             + (cs.DEPTH, cs.N_BINS, cs.O, "cosine", 0,
                                False)]
        for name, fast in (("bucketize", K.bucketize_cuda),
                           ("level_histogram", K.level_histogram_cuda),
                           ("level_score", K.level_score_cuda),
                           ("tree_build", K.tree_build_cuda)):
            t = cs.fit_kernel_times(name, inp[name], fast)
            print(json.dumps(dict(root=args.root, kernel=name, shape=shape,
                                  **t)), flush=True)
    time_predict(cs, K, rng, dev, args.root)
    return 0


def time_predict(cs, K, rng, dev, root: str) -> None:
    """K4 / K5 at the serving and the RL shapes: the wrapper (call, host,
    kernel) and the whole ``ops.predict.weighted_leaf_sum`` call."""
    import torch
    from gbrl_tpu_torch.config import TreeConfig
    from gbrl_tpu_torch.ensemble import ensemble_from_numpy
    from gbrl_tpu_torch.ops.predict import weighted_leaf_sum
    fused = "coeff" in inspect.signature(
        K.weighted_leaf_sum_cuda).parameters
    cases = [("serving", "weighted_leaf_sum", "greedy", cs.N, cs.F,
              cs.CAPACITY, cs.N_TREES),
             ("serving", "oblivious_leaf_sum", "oblivious", cs.N, cs.F,
              cs.CAPACITY, cs.N_TREES)] + list(cs.PREDICT_TIMES)
    for label, name, policy, n, f, cap, nt in cases:
        arrs = cs.synthetic_ensemble(rng, policy, f, cs.DEPTH, cap, nt)
        X = cs.observations(rng, arrs, n, f)
        coeff = rng.uniform(0.01, 0.1, size=(cap, cs.O)).astype(np.float32)
        t = [torch.from_numpy(np.ascontiguousarray(a)).to(dev) for a in
             (X, arrs["feat"], arrs["thr"], arrs["is_split"],
              arrs["leaf_values"])]
        cd = torch.from_numpy(coeff).to(dev)
        ntd = torch.tensor(nt, dtype=torch.int32, device=dev)
        a = tuple(t) + (cs.DEPTH, ntd, cd)
        fn = getattr(K, name + "_cuda")
        if fused:
            fast = fn
        else:
            w = t[4] * cd[:, None, :]
            fast = lambda *x, fn=fn, w=w: fn(*x[:4], w, x[5], x[6])  # noqa
        tm = cs.fit_kernel_times(name, [a], fast)
        cfg = TreeConfig(input_dim=f, output_dim=cs.O, n_num_features=f,
                         max_depth=cs.DEPTH, grow_policy=policy)
        ens = ensemble_from_numpy(arrs, "cuda")
        cfull = cd * (torch.arange(cap, device=dev) < nt)[:, None]

        def request():
            return weighted_leaf_sum(cfg, ens, t[0], cfull)
        k_ms, per_call = cs.device_ms(request)
        tm["request"] = dict(call_ms=cs.cuda_ms(request, cs.KERNEL_REPS),
                             host_ms=cs.enqueue_ms(request), kernel_ms=k_ms,
                             device_kernels=per_call)
        print(json.dumps(dict(root=root, kernel=name, shape=label, n=n, f=f,
                              t_cap=cap, n_trees=nt, fused=fused, **tm)),
              flush=True)


if __name__ == "__main__":
    sys.exit(main())
