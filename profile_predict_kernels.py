#!/usr/bin/env python3
"""Where K4 and K5 (ensemble predict) spend their device time, phase by
phase, on one NVIDIA GPU.

    python3 profile_predict_kernels.py [--seed 0]

Builds an instrumented copy of ``gbrl_tpu_torch`` under
``build/profile_predict_kernels/``: in the staged predict kernel, thread 0
of block 0 reads the device's global timer at the boundaries of each phase
and sums the time per phase (prologue: X's tile, ``n_trees`` and the first
stage; issuing the next stage's loads; the walk; storing the next stage;
the stage barrier; the rank reduction), and every block records when it
started and ended.  Then it runs K4 and K5 at ``chip_smoke.py``'s serving
shape (N = 4096, 1600 of 2048 trees, F = 16) and K4 / K5 at its
``PREDICT_TIMES`` RL shapes, and prints, per shape: block 0's
microseconds per phase for one launch (after warm-up), the spread of the
blocks' durations (the slowest block sets the kernel's time), how many
blocks started only after the first block ended (a second wave), and the
copy's call time (CUDA events) and device time (profiler).  The copy is
timed, not the kernels the port runs: the stamps cost a few instructions
per phase."""
import argparse
import ctypes
import importlib.util
import os
import shutil
import sys

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
HDR = '''
__device__ unsigned long long g_stamps[16];
__device__ unsigned long long g_blk[8192][2];
__device__ __forceinline__ unsigned long long gt() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}
#define MARK(k) { unsigned long long tn = gt(); T[k] += tn - tp; tp = tn; }
extern "C" int gbrl_read_prof(unsigned long long* h, unsigned long long* b) {
  int e = (int)cudaMemcpyFromSymbol(h, g_stamps, sizeof(g_stamps));
  return e ? e : (int)cudaMemcpyFromSymbol(b, g_blk, sizeof(g_blk));
}
'''
PHASES = {0: "prologue", 1: "load_next", 2: "walk", 3: "store_next",
          4: "sync", 5: "finish"}


def _insert(s: str, anchor: str, before: str = '', after: str = '') -> str:
    assert s.count(anchor) == 1, anchor
    return s.replace(anchor, before + anchor + after)


def instrument(src: str) -> None:
    """Stamp the staged kernel's body in the copy at ``src``/csrc."""
    path = os.path.join(src, "csrc", "predict.cu")
    s = open(path).read()
    ns = 'namespace cg = cooperative_groups;'
    s = s.replace(ns, ns + HDR, 1)
    s = _insert(s, '  const int O = OC ? OC : a.O, LO = (1 << D) * O;\n',
                before='  unsigned long long T[16] = {0}; unsigned long long'
                ' tp = gt(); const unsigned long long t_start = tp;\n')
    s = _insert(s, '  __syncthreads();\n  const float* xt = xs + lane;\n',
                after='  MARK(0)\n')
    s = _insert(s, '    walk_stage<OBL, D, OC>(a, cur, cnt, g, xt, acc, '
                'red);\n', before='    MARK(1)\n', after='    MARK(2)\n')
    s = _insert(s, '    __syncthreads();   // `nxt` is written and `cur` is '
                'free again\n', before='    MARK(3)\n',
                after='    MARK(4) T[8] += 1;\n')
    end = '  }\n  finish(a, red, acc, n0);\n}\n\n// At most 80 registers'
    s = _insert(s, end)
    s = s.replace(end, '  }\n  MARK(9)\n  finish(a, red, acc, n0);\n'
                '  MARK(5)\n  if (tid == 0) { g_blk[blockIdx.x][0] = t_start;'
                ' g_blk[blockIdx.x][1] = gt(); }\n'
                '  if (blockIdx.x == 0 && tid == 0)\n'
                '    for (int k = 0; k < 16; ++k) g_stamps[k] = T[k];\n'
                '}\n\n// At most 80 registers', 1)
    open(path, "w").write(s)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("profile_predict_kernels: no CUDA device", file=sys.stderr)
        return 1
    out = os.path.join(HERE, "build", "profile_predict_kernels")
    shutil.rmtree(out, ignore_errors=True)
    os.makedirs(out)
    shutil.copytree(os.path.join(HERE, "gbrl_tpu_torch"),
                    os.path.join(out, "gbrl_tpu_torch"))
    open(os.path.join(out, "pyproject.toml"), "w").close()
    instrument(os.path.join(out, "gbrl_tpu_torch"))
    spec = importlib.util.spec_from_file_location(
        "chip_smoke_helpers", os.path.join(HERE, "chip_smoke.py"))
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    sys.path.insert(0, out)
    from gbrl_tpu_torch.ops import kernels as K
    assert K.__file__.startswith(out), K.__file__
    lib = K._library()
    lib.gbrl_read_prof.argtypes = [ctypes.c_void_p, ctypes.c_void_p]
    rng = np.random.default_rng(args.seed)
    dev = torch.device("cuda")
    print(cs.smi_line())
    cases = [("serving", "weighted_leaf_sum", "greedy", cs.N, cs.F,
              cs.CAPACITY, cs.N_TREES),
             ("serving", "oblivious_leaf_sum", "oblivious", cs.N, cs.F,
              cs.CAPACITY, cs.N_TREES)] + list(cs.PREDICT_TIMES)
    for label, name, policy, n, f, cap, nt in cases:
        arrs = cs.synthetic_ensemble(rng, policy, f, cs.DEPTH, cap, nt)
        t = [torch.from_numpy(np.ascontiguousarray(a)).to(dev) for a in
             (cs.observations(rng, arrs, n, f), arrs["feat"], arrs["thr"],
              arrs["is_split"], arrs["leaf_values"])]
        cd = torch.from_numpy(rng.uniform(0.01, 0.1, size=(cap, cs.O))
                              .astype(np.float32)).to(dev)
        ntd = torch.tensor(nt, dtype=torch.int32, device=dev)
        fn = getattr(K, name + "_cuda")
        for _ in range(5):
            fn(*t, cs.DEPTH, ntd, cd)
        torch.cuda.synchronize()
        h = (ctypes.c_ulonglong * 16)()
        b = np.zeros((8192, 2), np.uint64)
        assert lib.gbrl_read_prof(ctypes.addressof(h), b.ctypes.data) == 0
        plan = K._predict_plan(n, f, cap, cs.DEPTH, cs.O,
                               policy == "oblivious")
        assert plan.staged and plan.grid <= len(b)
        bb = b[:plan.grid].astype(np.int64)
        st, en = bb[:, 0] - bb[:, 0].min(), bb[:, 1] - bb[:, 0].min()
        dur = en - st
        print(f"{label} {name} N={n} F={f} n_trees={nt} of {cap}: S={plan.S} "
              f"groups={plan.groups} tile={plan.tile} sb={plan.sb} "
              f"grid={plan.grid} smem={plan.smem}")
        print("  block 0 us:", {v: round(h[k] / 1e3, 3)
                                for k, v in PHASES.items()},
              f"stages {h[8]}")
        print(f"  blocks: duration min/mean/max {dur.min() / 1e3:.2f}/"
              f"{dur.mean() / 1e3:.2f}/{dur.max() / 1e3:.2f} us, last end "
              f"{en.max() / 1e3:.2f} us; started after the first end: "
              f"{int((st > en.min()).sum())}")
        ms = cs.cuda_ms(lambda: fn(*t, cs.DEPTH, ntd, cd), cs.KERNEL_REPS)
        k_ms, _ = cs.device_ms(lambda: fn(*t, cs.DEPTH, ntd, cd))
        print(f"  instrumented copy: call {ms:.5f} ms, kernel {k_ms} ms")
    return 0


if __name__ == "__main__":
    sys.exit(main())
