"""K2's launch plan (``ops.kernels._hist_plan``), checked on the CPU for
every shape the card tests and ``chip_smoke.py`` give the kernel: the
slices and the blocks' shares of them cover every (feature, column, bucket)
exactly once, the sample tiles cover every sample once, and each block stays
within the shared-memory budget, the portable cluster size and the grid's
limits.  The index arithmetic below repeats ``level_hist_kernel``'s
(``csrc/fit.cu``)."""
import numpy as np
import pytest

from gbrl_tpu_torch.ops import kernels as K

SHAPES = ([(4096, 16, c, 257) for c in (4, 8, 16, 32)]       # bench levels
          + [(512, 4, c, 257) for c in (4, 8, 16, 32)]       # PPO minibatch
          + [(10, 3, 8, 9), (33, 3, 8, 257), (777, 5, 16, 1025),
             (1000, 300, 8, 257), (4096, 16, 1, 257), (100, 4, 4, 1),
             (1000, 4, 24, 257), (300, 2, 4, 100_000)])      # bucket ranges


def _coverage(plan: K.HistPlan, F: int, C: int, NB: int) -> np.ndarray:
    """How often the kernel writes each out[f, c, b] under ``plan``."""
    S, fs, cs, br = plan.S, plan.fs, plan.cs, plan.br
    hw = -(-(fs * cs * br) // 4) * 4
    q4 = hw // 4
    per = -(-q4 // S)
    hits = np.zeros((F, C, NB), np.int64)
    for bx in range(plan.grid[0]):
        f0, rank = (bx // S) * fs, bx % S
        nfs = min(fs, F - f0)
        flat = np.arange(4 * rank * per, 4 * min(q4, rank * per + per))
        j, rem = np.divmod(flat, cs * br)
        c, bl = np.divmod(rem, br)
        for by in range(plan.grid[1]):
            c0 = by * cs
            ncs = min(cs, C - c0)
            for bz in range(plan.grid[2]):
                b0 = bz * br
                nbr = min(br, NB - b0)
                ok = (j < nfs) & (c < ncs) & (bl < nbr)
                np.add.at(hits, (f0 + j[ok], c0 + c[ok], b0 + bl[ok]), 1)
    return hits


@pytest.mark.parametrize("N,F,C,NB", SHAPES)
def test_hist_plan_covers_each_bin_once(N, F, C, NB):
    plan = K._hist_plan(N, F, C, NB)
    assert plan.smem == K._hist_smem(plan.fs, plan.cs, plan.br)
    assert plan.smem <= K.HIST_SMEM_BUDGET
    assert plan.S in (1, 2, 4, 8) and plan.S <= K.HIST_MAX_CLUSTER
    assert plan.grid[0] % plan.S == 0
    assert max(plan.grid[1:]) <= 65535
    assert K.HIST_SUB <= 1 << 16              # u16 sample lists
    # every sample in exactly one rank's tile, each tile at least
    # HIST_MIN_TILE samples once the cluster has grown
    starts = np.arange(plan.S) * plan.tile
    seen = np.zeros(N, np.int64)
    for s in starts:
        seen[s:min(N, s + plan.tile)] += 1
    assert (seen == 1).all()
    assert plan.S == 1 or plan.tile >= K.HIST_MIN_TILE
    assert (_coverage(plan, F, C, NB) == 1).all()


def test_hist_plan_depends_on_shapes_only():
    """The main-path shapes take one cluster plan each: eight blocks per
    slice, one feature per warp, every bucket in one slice."""
    for N, C in ((4096, 32), (512, 4)):
        plan = K._hist_plan(N, 16 if N == 4096 else 4, C, 257)
        assert (plan.S, plan.fs, plan.br) == (8, 4, 257)
        assert plan == K._hist_plan(N, 16 if N == 4096 else 4, C, 257)
