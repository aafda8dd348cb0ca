#!/usr/bin/env python3
"""Time K1 (bucketize), K2 (level histogram), K3 (level split score) and K6
(whole tree) of one checkout of gbrl_tpu_torch on one NVIDIA GPU, at the
bench shape (N = 4096, F = 16) and the PPO minibatch shape (N = 512,
F = 4), K1 and K2 beside torch.searchsorted and index_add_ on the same
inputs.

    python3 time_fit_kernels.py [--root DIR] [--seed 0]

``--root`` names the checkout whose ``gbrl_tpu_torch`` is timed (default:
this one), so two versions can be compared on one card in one go:
run parent, change, change, parent.  Inputs, timing and bounds are
``chip_smoke.py``'s (``fit_time_inputs``, ``fit_kernel_times``): call_ms is
the median single call between CUDA events, kernel_ms the profiler's
device time per call; K2's and K3's numbers are one tree's four levels
summed; K6 fits one greedy cosine tree of depth 4 on ``tree_inputs``.
Prints one JSON line per kernel and shape."""
import argparse
import importlib.util
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
    return 0


if __name__ == "__main__":
    sys.exit(main())
