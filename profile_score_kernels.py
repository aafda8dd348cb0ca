#!/usr/bin/env python3
"""Where K3 (level split score) and K6 (whole tree) spend their device time,
phase by phase, on one NVIDIA GPU.

    python3 profile_score_kernels.py [--seed 0]

Builds instrumented copies of ``gbrl_tpu_torch/csrc/fit.cu`` and
``tree.cu`` under ``build/profile_score_kernels/``: thread 0 of the first
block reads the device's global timer at the boundaries of each phase and
sums the time per phase (K3: staging, prefix sums, node totals, scoring,
max with its cluster barrier, first hit, output, last barrier; K6: the
histogram's staging, node lists and adds, the wait at the first barrier,
the rank reduction, prefix sums, node totals with the second barrier,
scoring, the selection's two halves, the leaves).  Then it runs K3 on one
tree's levels and K6 on one tree, greedy and oblivious, at the bench shape
(N = 4096, F = 16) and the PPO minibatch shape (N = 512, F = 4), with
``chip_smoke.py``'s inputs, and prints microseconds per phase for one
launch (after warm-up) beside the wrappers' host and call times.  The
copies are timed, not the kernels the port runs: the stamps cost a few
instructions per phase."""
import argparse
import ctypes
import importlib.util
import os
import shutil
import subprocess
import sys

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
HDR = '''
__device__ unsigned long long g_stamps[16];
__device__ __forceinline__ unsigned long long gt() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}
#define MARK(k) { unsigned long long tn = gt(); T[k] += tn - tp; tp = tn; }
extern "C" int gbrl_read_stamps_NAME(unsigned long long* h) {
  return (int)cudaMemcpyFromSymbol(h, g_stamps, sizeof(g_stamps));
}
'''
STAMP_START = '  unsigned long long T[16] = {0}; unsigned long long tp = gt();\n'
K3_PHASES = ['stage', 'scan', 'tot', 'score', 'max+sync', 'first', 'out',
             'sync']
K6_PHASES = ['Hzero', 'syncA', 'R', 'scan', 'syncB+tot', 'S', 'sel1+syncC',
             'sel2+syncD', 'leaf', 'Hstage', 'Hlists', 'Hadds']


def _insert(s: str, anchor: str, before: str = '', after: str = '') -> str:
    assert s.count(anchor) == 1, anchor
    return s.replace(anchor, before + anchor + after)


def instrument(src: str, out: str) -> None:
    """Write the stamped copies of fit.cu and tree.cu to ``out``."""
    ns = 'namespace cg = cooperative_groups;'
    s = open(os.path.join(src, 'fit.cu')).read()
    s = s.replace(ns, ns + HDR.replace('NAME', 'fit'), 1)
    s = _insert(s, '  const int tid = threadIdx.x;\n  auto hrow',
                before=STAMP_START)
    s = _insert(s, '        gbrl::scan_rows(stage, own + extra, NB, NBp);\n'
                '        __syncthreads();\n',
                before='        MARK(0)\n', after='        MARK(1)\n')
    s = _insert(s, '        const bool last = c0 + nn == NS;',
                before='        MARK(2)\n')
    s = _insert(s, '      if (pass == 1) {', before='      MARK(3)\n')
    s = _insert(s, '      lim = gbrl::band_limit(m, a.oblivious ? 0.0f : '
                'fabsf(tot[K]));\n', after='      MARK(4)\n')
    s = _insert(s, '  // the first hit over the cluster', before='  MARK(5)\n')
    s = _insert(s, "  cluster.sync();   // every rank's exchange stays alive "
                "until rank 0 has read\n", before='  MARK(6)\n',
                after='  MARK(7)\n  if (blockIdx.x == 0 && tid == 0)\n'
                '    for (int k = 0; k < 8; ++k) g_stamps[k] = T[k];\n')
    open(os.path.join(out, 'fit.cu'), 'w').write(s)
    s = open(os.path.join(src, 'tree.cu')).read()
    s = s.replace(ns, ns + HDR.replace('NAME', 'tree'), 1)
    s = _insert(s, '  const int tid = threadIdx.x, w = tid >> 5, '
                'lane = tid & 31;\n', before=STAMP_START)
    s = _insert(s, "      cluster.sync();\n      // R: the owned",
                before='      MARK(0)\n')
    s = s.replace("      cluster.sync();\n      // R: the owned",
                  "      cluster.sync();\n      MARK(1)\n      // R: the owned")
    s = _insert(s, '      gbrl::scan_rows(red, own * ru, NB, NBp);\n'
                '      __syncthreads();\n',
                before='      MARK(2)\n', after='      MARK(3)\n')
    s = _insert(s, "      // S: the owned units' candidate values",
                before='      MARK(4)\n')
    s = _insert(s, '      slot0 += own;\n', after='      MARK(5)\n')
    s = _insert(s, '    node_max(lm, shf, xmax);\n    cluster.sync();\n',
                after='    MARK(6)\n')
    s = _insert(s, '    __syncthreads();\n  }\n  // the leaves: wg summed')
    s = s.replace('    __syncthreads();\n  }\n  // the leaves: wg summed',
                  '    __syncthreads();\n    MARK(7)\n  }\n'
                  '  // the leaves: wg summed')
    s = _insert(s, '        stage_sub(a, s0, ns, d, a.bgw, ga, ng, cq, csp, '
                'srel, sv, sxb);\n        __syncthreads();\n',
                after='        MARK(9)\n')
    s = _insert(s, '        build_lists(ns, nact, srel, list, cnt);\n'
                '        __syncthreads();\n', after='        MARK(10)\n')
    s = _insert(s, '            __syncwarp();\n          }\n        }\n      }\n'
                '      MARK(0)\n')
    s = s.replace('            __syncwarp();\n          }\n        }\n      }\n'
                  '      MARK(0)\n',
                  '            __syncwarp();\n          }\n        }\n'
                  '        MARK(11)\n      }\n      MARK(0)\n')
    s = _insert(s, "  cluster.sync();   // every rank's leaf sums stay alive "
                "until rank 0 has read\n",
                after='  MARK(8)\n  if (rank == 0 && tid == 0)\n'
                '    for (int k = 0; k < 12; ++k) g_stamps[k] = T[k];\n')
    assert s.count('MARK(') == 13, s.count('MARK(')
    open(os.path.join(out, 'tree.cu'), 'w').write(s)


def build(out: str) -> str:
    """nvcc the stamped copies with predict.cu into one library."""
    src = os.path.join(HERE, 'gbrl_tpu_torch', 'csrc')
    for name in ('predict.cu', 'score.cuh'):
        shutil.copy(os.path.join(src, name), out)
    instrument(src, out)
    sys.path.insert(0, HERE)
    from gbrl_tpu_torch.ops import kernels as K
    nvcc = K._nvcc()
    objs = [os.path.join(out, n + '.o') for n in ('predict', 'fit', 'tree')]
    procs = [subprocess.Popen([nvcc, *K.NVCC_FLAGS, '-c', o[:-2] + '.cu',
                               '-o', o]) for o in objs]
    assert all(p.wait() == 0 for p in procs), 'nvcc failed'
    lib = os.path.join(out, 'libprofile.so')
    subprocess.check_call([nvcc, *K.LINK_FLAGS, '-o', lib, *objs])
    return lib


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument('--seed', type=int, default=0)
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print('profile_score_kernels: no CUDA device', file=sys.stderr)
        return 1
    out = os.path.join(HERE, 'build', 'profile_score_kernels')
    os.makedirs(out, exist_ok=True)
    so = build(out)
    from gbrl_tpu_torch.ops import kernels as K
    K.build_library = lambda: so
    lib = K._library()
    for which in ('fit', 'tree'):
        getattr(lib, 'gbrl_read_stamps_' + which).argtypes = [ctypes.c_void_p]
    spec = importlib.util.spec_from_file_location(
        'chip_smoke_helpers', os.path.join(HERE, 'chip_smoke.py'))
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    buf = (ctypes.c_ulonglong * 16)()

    def phases(fn, which: str, names: list) -> str:
        for _ in range(3):
            fn()
        torch.cuda.synchronize()
        fn()
        torch.cuda.synchronize()
        getattr(lib, 'gbrl_read_stamps_' + which)(ctypes.addressof(buf))
        us = [buf[i] / 1e3 for i in range(len(names))]
        return (' '.join(f'{k}={v:.2f}' for k, v in zip(names, us))
                + f' total={sum(us):.2f} us | host_ms '
                f'{cs.enqueue_ms(fn):.5f} call_ms {cs.cuda_ms(fn, 30):.5f}')

    rng = np.random.default_rng(args.seed)
    dev = torch.device('cuda')
    print(cs.smi_line())
    for shape, (n, f) in (('bench', (cs.N, cs.F)),
                          ('ppo', (cs.PPO_N, cs.PPO_F))):
        inp = cs.fit_time_inputs(K, rng, dev, n, f)
        levels = cs.level_score_inputs(K, dev, inp['level_histogram'])
        for d, a in enumerate(levels):
            for obl in (False, True):
                a2 = a[:7] + (obl,) + a[8:]
                print(f'K3 {shape} level {d} oblivious={obl}: '
                      + phases(lambda: K.level_score_cuda(*a2), 'fit',
                               K3_PHASES), flush=True)
        for obl in (False, True):
            a = cs.tree_inputs(rng, dev, n, f, False, False) + (
                cs.DEPTH, cs.N_BINS, cs.O, 'cosine', 0, obl)
            print(f'K6 {shape} oblivious={obl}: '
                  + phases(lambda: K.tree_build_cuda(*a), 'tree', K6_PHASES),
                  flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main())
