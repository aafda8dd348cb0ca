"""Hand-written CUDA kernels (K1-K6) and their plain PyTorch versions.

Counterpart of ``gbrl_tpu/ops/pallas_kernels.py``:

- ``bucketize_cuda``          replaces ``bucketize_pallas`` (K1);
- ``level_histogram_cuda``    replaces ``level_histogram_pallas`` (K2);
- ``level_score_cuda``        replaces ``level_score_pallas`` (K3);
- ``tree_build_cuda``         replaces ``tree_build_pallas`` (K6);
- ``weighted_leaf_sum_cuda``  replaces ``weighted_leaf_sum_pallas`` (K4);
- ``oblivious_leaf_sum_cuda`` replaces ``oblivious_leaf_sum_pallas`` (K5).

K1-K3 are the fit path (``csrc/fit.cu``): bucket ids, one level's gradient
histogram, one level's split choice. K6 (``csrc/tree.cu``) fits a whole
numeric tree of depth <= 4 in one launch of a thread-block cluster. K4 and
K5 compute ``sum_{t < n_trees} w[t, leaf(n, t), :] -> [N, O]`` with ``w =
leaf_values * coeff``, the product taken as the trees are staged
(``csrc/predict.cu``). The CUDA sources
are compiled at first use with ``nvcc``, one process per source started
together, and linked into one shared library with a C interface, keyed by a
hash of the sources and flags, and loaded with ``ctypes``. The library goes
under ``build/gbrl_tpu_torch_kernels/`` at the root of a source checkout,
under ``$GBRL_TPU_TORCH_BUILD_DIR`` if that is set, and otherwise (an
installed package) under ``$XDG_CACHE_HOME`` or ``~/.cache``, in
``gbrl_tpu_torch_kernels/``.

A wrapper given CPU tensors runs the plain version.  Given CUDA tensors it
launches the kernel or raises: it never falls back.  Each wrapper counts its
calls that launch on the card in ``launch_counts`` (one per call, each one
device kernel; the CPU branch does not count) and in the counter
``launch.<key>`` of ``utils/profiling.py``, which credits the open span.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path
from typing import Callable, NamedTuple, Union

import torch

from ..utils.profiling import count

CSRC = Path(__file__).resolve().parent.parent / "csrc"
SOURCES = ("predict.cu", "fit.cu", "tree.cu")
# headers the sources include: part of the build key
HEADERS = ("score.cuh",)
# per-source compile flags; the objects are linked with -shared
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-O3", "-std=c++17",
              "-Xcompiler", "-fPIC")
LINK_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-shared")
LIB_NAME = "libgbrl_kernels.so"
BUILD_NAME = "gbrl_tpu_torch_kernels"

# K4/K5's launch plan (predict.cu): a block takes at most PREDICT_MAX_TILE
# samples (one per thread), at least PREDICT_MIN_TILE; up to
# PREDICT_SPLIT_N samples (and PREDICT_OREG columns), a block instead takes
# PREDICT_MIN_TILE samples and splits its trees over PREDICT_GROUPS warp
# groups, with no cluster; past it, clusters of up to
# PREDICT_MAX_CLUSTER blocks (past the portable 8) split the trees, chunk c of
# PREDICT_CHUNK trees going to rank c % S (predict.cu CHUNK); the cluster
# grows while the grid stays within PREDICT_TARGET_BLOCKS blocks and each
# rank keeps two chunks of the capacity.  A block stages its trees in two
# buffers of at most PREDICT_STAGE trees, at least PREDICT_GROUP, within
# PREDICT_SMEM_BUDGET bytes; PREDICT_PREFETCH staged units a thread per round
# (predict.cu PF); up to PREDICT_OREG output columns summed in registers
# (OREG); depths up to PREDICT_MAX_STAGED_DEPTH have staged instances
PREDICT_MAX_TILE = 256
PREDICT_MIN_TILE = 32
PREDICT_SPLIT_N = 2048
PREDICT_GROUPS = 8
PREDICT_MAX_CLUSTER = 16
PREDICT_CHUNK = 8
PREDICT_TARGET_BLOCKS = 256
PREDICT_STAGE = 32
PREDICT_GROUP = 8
PREDICT_SMEM_BUDGET = 96 * 1024
PREDICT_PREFETCH = 4
PREDICT_OREG = 8
PREDICT_MAX_STAGED_DEPTH = 8
PLAIN_TREE_CHUNK = 512

launch_counts = {"bucketize": 0, "level_histogram": 0, "level_score": 0,
                 "tree_build": 0, "weighted_leaf_sum": 0,
                 "oblivious_leaf_sum": 0}


def reset_launch_counts() -> None:
    for k in launch_counts:
        launch_counts[k] = 0


def _launched(key: str) -> None:
    """One call launched kernel ``key`` on the card: ``launch_counts`` and
    the program's ``launch.<key>`` counter (credited to the open span)."""
    launch_counts[key] += 1
    count(_LAUNCH_NAMES[key])


_LAUNCH_NAMES = {k: "launch." + k for k in launch_counts}


# ------------------------------------------------------------ plain versions
def _live(n_trees: Union[int, torch.Tensor], capacity: int) -> int:
    return max(0, min(int(n_trees), capacity))


def _leaf_sum_plain(leaf_fn: Callable, X: torch.Tensor, w: torch.Tensor,
                    n_trees, coeff=None) -> torch.Tensor:
    """Shared summation of both plain versions: trees in chunks of
    PLAIN_TREE_CHUNK, ``leaf_fn(t0, t1) -> [N, t1 - t0]`` leaf indices; a
    chunk's weights are ``w[t0:t1] * coeff[t0:t1, None, :]`` when ``coeff``
    is given (the elementwise product of a pre-scaled ``w``, so the same
    bits).  Only the leaf indices differ between K4 and K5, so on an
    oblivious ensemble the two plain versions give the same bits."""
    N = X.shape[0]
    O = w.shape[-1]
    nt = _live(n_trees, w.shape[0])
    acc = torch.zeros((N, O), dtype=torch.float32, device=X.device)
    for t0 in range(0, nt, PLAIN_TREE_CHUNK):
        t1 = min(nt, t0 + PLAIN_TREE_CHUNK)
        leaf = leaf_fn(t0, t1)                                  # [N, C]
        wc = w[t0:t1] if coeff is None else w[t0:t1] * coeff[t0:t1, None, :]
        trees = torch.arange(t1 - t0, device=X.device)[None, :]
        acc = acc + wc[trees, leaf].sum(dim=1)                  # [N, C, O]
    return acc


def weighted_leaf_sum_plain(X: torch.Tensor, feat: torch.Tensor,
                            thr: torch.Tensor, is_split: torch.Tensor,
                            w: torch.Tensor, max_depth: int,
                            n_trees, coeff=None) -> torch.Tensor:
    """K4's function in plain torch: direct heap walk ``p = 2p + 1 + go``
    with ``go = is_split & (x[max(feat, 0)] > thr)``; ``w`` the leaf values,
    scaled by ``coeff`` [T, O] when it is given."""
    IN = (1 << max_depth) - 1

    def leaf_fn(t0, t1):
        C = t1 - t0
        ft = feat[t0:t1].reshape(-1)
        th = thr[t0:t1].reshape(-1)
        sp = is_split[t0:t1].reshape(-1)
        base = (torch.arange(C, device=X.device) * IN)[None, :]
        p = torch.zeros((X.shape[0], C), dtype=torch.long, device=X.device)
        for _ in range(max_depth):
            idx = base + p
            f = ft[idx].long().clamp_(min=0)
            go = sp[idx] & (torch.gather(X, 1, f) > th[idx])
            p = 2 * p + 1 + go.long()
        return p - IN

    return _leaf_sum_plain(leaf_fn, X, w, n_trees, coeff)


def oblivious_leaf_sum_plain(X: torch.Tensor, feat: torch.Tensor,
                             thr: torch.Tensor, is_split: torch.Tensor,
                             w: torch.Tensor, max_depth: int,
                             n_trees, coeff=None) -> torch.Tensor:
    """K5's function in plain torch: one (feat, thr, is_split) per level,
    read at the level-lead slot ``2^d - 1``, packed into a leaf bit index
    (arguments as ``weighted_leaf_sum_plain``)."""
    lead = [(1 << d) - 1 for d in range(max_depth)]

    def leaf_fn(t0, t1):
        leaf = torch.zeros((X.shape[0], t1 - t0), dtype=torch.long,
                           device=X.device)
        for d in lead:
            f = feat[t0:t1, d].long().clamp_(min=0)
            go = is_split[t0:t1, d][None, :] & (X[:, f] > thr[t0:t1, d][None, :])
            leaf = 2 * leaf + go.long()
        return leaf

    return _leaf_sum_plain(leaf_fn, X, w, n_trees, coeff)


# ------------------------------------------------------------------- build
def _nvcc() -> str:
    for cand in (os.environ.get("CUDA_HOME"), os.environ.get("CUDA_PATH")):
        if cand and (Path(cand) / "bin" / "nvcc").exists():
            return str(Path(cand) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found:
        return found
    if Path("/usr/local/cuda/bin/nvcc").exists():
        return "/usr/local/cuda/bin/nvcc"
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built "
                       "(set CUDA_HOME)")


def build_dir() -> Path:
    """Where the compiled library is kept (see the module docstring)."""
    env = os.environ.get("GBRL_TPU_TORCH_BUILD_DIR")
    if env:
        return Path(env)
    root = Path(__file__).resolve().parents[2]
    if (root / "pyproject.toml").exists():            # a source checkout
        return root / "build" / BUILD_NAME
    cache = os.environ.get("XDG_CACHE_HOME") or Path.home() / ".cache"
    return Path(cache) / BUILD_NAME


def _source_key() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS + LINK_FLAGS).encode())
    for name in SOURCES + HEADERS:
        h.update(name.encode())
        h.update((CSRC / name).read_bytes())
    return h.hexdigest()[:16]


def _run_all(cmds) -> None:
    """Run the commands as parallel processes; raise on the first failure
    after all have ended."""
    procs = [(cmd, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                    stderr=subprocess.STDOUT, text=True))
             for cmd in cmds]
    outs = [(cmd, p.communicate()[0], p.returncode) for cmd, p in procs]
    for cmd, out, rc in outs:
        if rc != 0:
            raise RuntimeError("nvcc failed building the kernels:\n"
                               + " ".join(cmd) + "\n" + out)


def build_library() -> Path:
    """Compile each source to an object (one nvcc per source, all started
    together) and link them into ``build_dir()/<hash>/libgbrl_kernels.so``
    unless that file exists; returns its path.  The library is written to a
    temporary name and renamed, so concurrent builders never load a partial
    file."""
    out_dir = build_dir() / _source_key()
    lib = out_dir / LIB_NAME
    if lib.exists():
        return lib
    out_dir.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    with tempfile.TemporaryDirectory(dir=out_dir) as tmp_dir:
        objs = [str(Path(tmp_dir) / (Path(name).stem + ".o"))
                for name in SOURCES]
        _run_all([[nvcc, *NVCC_FLAGS, "-c", str(CSRC / name), "-o", obj]
                  for name, obj in zip(SOURCES, objs)])
        tmp_lib = str(Path(tmp_dir) / LIB_NAME)
        _run_all([[nvcc, *LINK_FLAGS, "-o", tmp_lib, *objs]])
        os.replace(tmp_lib, lib)
    return lib


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    lib = ctypes.CDLL(str(build_library()))
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    for name in ("gbrl_k4_leaf_sum", "gbrl_k5_leaf_sum"):
        fn = getattr(lib, name)
        fn.argtypes = [ptr] * 11
        fn.restype = i32
    lib.gbrl_predict_prepare.argtypes = [i32]
    lib.gbrl_predict_prepare.restype = i32
    lib.gbrl_predict_max_clusters.argtypes = [i32, ptr]
    lib.gbrl_predict_max_clusters.restype = i32
    lib.gbrl_max_smem_optin.argtypes = [i32]
    lib.gbrl_max_smem_optin.restype = i32
    lib.gbrl_cuda_error_string.argtypes = [i32]
    lib.gbrl_cuda_error_string.restype = ctypes.c_char_p
    lib.gbrl_fit_prepare.argtypes = [i32]
    lib.gbrl_k1_bucketize.argtypes = [ptr] * 3 + [i32] * 5 + [ptr]
    lib.gbrl_k2_level_histogram.argtypes = [ptr] * 3 + [i32] * 9 + [ptr]
    lib.gbrl_k2_max_clusters.argtypes = [i32] * 4
    lib.gbrl_k3_level_score.argtypes = [ptr] * 6 + [ctypes.c_float, ptr]
    lib.gbrl_k3_max_clusters.argtypes = [i32] * 2
    for name in ("gbrl_fit_prepare", "gbrl_k1_bucketize",
                 "gbrl_k2_level_histogram", "gbrl_k2_max_clusters",
                 "gbrl_k3_level_score", "gbrl_k3_max_clusters"):
        getattr(lib, name).restype = i32
    lib.gbrl_k6_tree_build.argtypes = [ptr] * 11 + [ctypes.c_float, ptr]
    lib.gbrl_k6_prepare.argtypes = [i32]
    lib.gbrl_k6_max_clusters.argtypes = [i32] * 2
    for name in ("gbrl_k6_tree_build", "gbrl_k6_prepare",
                 "gbrl_k6_max_clusters"):
        getattr(lib, name).restype = i32
    return lib


# ---------------------------------------------------------------- wrappers
def _check(X, feat, thr, is_split, w, max_depth, n_trees, coeff) -> None:
    dev = X.device
    named = dict(X=X, feat=feat, thr=thr, is_split=is_split, w=w,
                 n_trees=n_trees)
    if coeff is not None:
        named["coeff"] = coeff
    for name, t in named.items():
        if not isinstance(t, torch.Tensor) or t.device != dev:
            raise ValueError(f"{name} must be a tensor on {dev}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    want = dict(X=torch.float32, feat=torch.int32, thr=torch.float32,
                is_split=torch.bool, w=torch.float32, n_trees=torch.int32,
                coeff=torch.float32)
    for name, t in named.items():
        if t.dtype != want[name]:
            raise ValueError(f"{name} must be {want[name]}, got {t.dtype}")
    IN, L = (1 << max_depth) - 1, 1 << max_depth
    T = feat.shape[0]
    if X.dim() != 2 or X.shape[1] < 1:
        raise ValueError(f"X must be [N, F] with F >= 1, got {tuple(X.shape)}")
    for name, t in (("feat", feat), ("thr", thr), ("is_split", is_split)):
        if tuple(t.shape) != (T, IN):
            raise ValueError(f"{name} must be [{T}, {IN}], got "
                             f"{tuple(t.shape)}")
    if w.dim() != 3 or tuple(w.shape[:2]) != (T, L):
        raise ValueError(f"w must be [{T}, {L}, O], got {tuple(w.shape)}")
    if coeff is not None and tuple(coeff.shape) != (T, w.shape[2]):
        raise ValueError(f"coeff must be [{T}, {w.shape[2]}], got "
                         f"{tuple(coeff.shape)}")
    if n_trees.numel() != 1:
        raise ValueError("n_trees must hold one int32")


class PredictPlan(NamedTuple):
    """K4/K5's launch plan: ``grid`` blocks of ``tile`` samples x ``groups``
    warp groups in clusters of ``S``, chunk c of ``chunk`` trees going to
    rank c % S, each rank walking its chunks in order, group g its
    positions q with q % groups == g; ``staged``: X's
    tile ([F][tile] at ``x_off``) and the rank's trees (two buffers of ``sb``
    trees, ``buf`` bytes each, at ``ring_off``) in shared memory, else read
    from global memory; the block's [O][tile] partial sums at ``red_off`` or,
    with ``red_global``, in ``scratch`` floats of global memory; ``smem``
    bytes per block (predict.cu)."""
    S: int
    groups: int
    chunk: int
    tile: int
    staged: int
    sb: int
    red_global: int
    x_off: int
    ring_off: int
    buf: int
    red_off: int
    smem: int
    grid: int
    scratch: int


def _predict_groups(N: int, O: int) -> int:
    """Warp groups a block splits its trees over: PREDICT_GROUPS up to
    PREDICT_SPLIT_N samples and PREDICT_OREG columns (blocks of
    PREDICT_MIN_TILE samples: a small request or A2C's 1024 rows fills
    blocks without a cluster's barriers), else 1."""
    return (PREDICT_GROUPS if N <= PREDICT_SPLIT_N and O <= PREDICT_OREG
            else 1)


def _predict_ranks(N: int, T_cap: int, groups: int = 1) -> int:
    """The cluster size, from N and the capacity alone (1 with warp
    groups): it doubles while the grid at the largest tile stays within
    PREDICT_TARGET_BLOCKS and each rank keeps at least two chunks of the
    capacity.  S, the groups and the chunk fix the order of every add, so
    K4 and K5 (and every route) share them."""
    if groups > 1:
        return 1
    tiles = -(-N // PREDICT_MAX_TILE)
    chunks = -(-T_cap // PREDICT_CHUNK)
    S = 1
    while (S < PREDICT_MAX_CLUSTER and 2 * S * tiles <= PREDICT_TARGET_BLOCKS
           and chunks >= 4 * S):
        S *= 2
    return S


def _predict_layout(F: int, O: int, K: int, LO: int, tile: int, sb: int,
                    red: int):
    """(x_off, ring_off, buf, red_off, smem) in bytes: X's tile, two stage
    buffers of ``sb`` trees (K packed nodes of 8 bytes, LO leaf values), the
    partial sums of ``red`` groups ([red][O][tile]; 0: none); 16-byte
    aligned regions (sb = 0: nothing staged)."""
    x = -(-4 * F * tile // 16) * 16 if sb else 0
    buf = -(-sb * (8 * K + 4 * LO) // 16) * 16
    red_off = x + 2 * buf
    return 0, x, buf, red_off, red_off + 4 * O * tile * red


@functools.lru_cache(maxsize=256)
def _predict_plan(N: int, F: int, T_cap: int, D: int, O: int,
                  oblivious: bool) -> PredictPlan:
    """K4/K5's launch plan from the shapes alone: the ranks
    (``_predict_ranks``); then the largest tile (halving down to
    PREDICT_MIN_TILE) whose block holds X's tile and two buffers of a group
    (PREDICT_GROUP trees) within PREDICT_SMEM_BUDGET, with as many trees a
    buffer (up to PREDICT_STAGE) as a prefetch round (with warp groups: as
    the budget allows, so few trees take few stages) and the budget allow;
    where no tile holds a group (or past PREDICT_MAX_STAGED_DEPTH) the
    global route, its partial sums in global scratch past the budget."""
    K = D if oblivious else (1 << D) - 1
    LO = (1 << D) * O
    G = _predict_groups(N, O)
    S = _predict_ranks(N, T_cap, G)
    top = (PREDICT_MIN_TILE if G > 1 else
           min(PREDICT_MAX_TILE, max(PREDICT_MIN_TILE, -(-N // 32) * 32)))
    red = G if G > 1 else int(S > 1 or O > PREDICT_OREG)

    def plan(tile, sb, red_global):
        lay = _predict_layout(F, O, K, LO, tile, sb,
                              0 if red_global else red)
        grid = -(-N // tile) * S
        return PredictPlan(S, G, PREDICT_CHUNK, tile, int(sb > 0), sb,
                           int(red_global), *lay, grid,
                           grid * O * tile if red_global else 0)

    tile = top
    while D <= PREDICT_MAX_STAGED_DEPTH and tile >= PREDICT_MIN_TILE:
        sb = PREDICT_STAGE
        while sb > PREDICT_GROUP and (
                (G == 1 and sb * (K + LO) > PREDICT_PREFETCH * tile)
                or plan(tile, sb, 0).smem > PREDICT_SMEM_BUDGET):
            sb //= 2
        p = plan(tile, sb, 0)
        if p.smem <= PREDICT_SMEM_BUDGET:
            return p
        tile //= 2
    return plan(top, 0, int(red and 4 * O * top > PREDICT_SMEM_BUDGET))


@functools.lru_cache(maxsize=None)
def _predict_ready(index: int) -> None:
    """Once per device: every predict instance may use the device's opt-in
    shared memory and clusters past the portable size."""
    lib = _library()
    with torch.cuda.device(index):
        rc = lib.gbrl_predict_prepare(_smem_limit(index))
    if rc != 0:
        raise RuntimeError(f"gbrl_predict_prepare failed: CUDA error {rc} "
                           f"({lib.gbrl_cuda_error_string(rc).decode()})")


@functools.lru_cache(maxsize=256)
def _predict_params(index: int, N: int, F: int, T_cap: int, D: int, O: int,
                    oblivious: bool):
    """Once per device and shape: the plan, the device readied and the
    cluster checked with the device (raises when it refuses it); returns
    (plan, predict.cu's int array P_N ... P_SMEM)."""
    plan = _predict_plan(N, F, T_cap, D, O, oblivious)
    if plan.grid >= 1 << 31:
        raise ValueError(f"predict: grid of {plan.grid} blocks too large")
    _smem_fits(torch.device("cuda", index), plan.smem, "predict")
    _predict_ready(index)
    vals = [N, F, T_cap, D, O, plan.S, plan.groups, plan.chunk, plan.tile,
            plan.sb,
            1 - plan.staged, plan.red_global, plan.x_off, plan.ring_off,
            plan.buf, plan.red_off, plan.smem]
    params = (ctypes.c_int * len(vals))(*vals)
    with torch.cuda.device(index):
        n = _library().gbrl_predict_max_clusters(int(oblivious),
                                                 ctypes.addressof(params))
    if n < 1:
        raise RuntimeError(f"predict: the device cannot run a cluster of "
                           f"{plan.S} blocks of {plan.tile * plan.groups} "
                           f"threads with "
                           f"{plan.smem} B of shared memory each (query "
                           f"returned {n})")
    return plan, params


def _launch(fn_name: str, count_key: str, oblivious: bool, X, feat, thr,
            is_split, w, max_depth: int, n_trees, coeff) -> torch.Tensor:
    _check(X, feat, thr, is_split, w, max_depth, n_trees, coeff)
    N, F = X.shape
    O = w.shape[-1]
    dev = X.device
    out = torch.empty((N, O), dtype=torch.float32, device=dev)
    if N == 0 or O == 0:
        return out
    plan, params = _predict_params(_index(dev), N, F, feat.shape[0],
                                   max_depth, O, oblivious)
    scratch = (torch.empty(plan.scratch, dtype=torch.float32, device=dev)
               if plan.red_global else None)
    _call(_library(), fn_name, dev, X.data_ptr(), feat.data_ptr(),
          thr.data_ptr(), is_split.data_ptr(), w.data_ptr(),
          None if coeff is None else coeff.data_ptr(), n_trees.data_ptr(),
          out.data_ptr(), None if scratch is None else scratch.data_ptr(),
          ctypes.addressof(params))
    _launched(count_key)
    return out


def weighted_leaf_sum_cuda(X: torch.Tensor, feat: torch.Tensor,
                           thr: torch.Tensor, is_split: torch.Tensor,
                           w: torch.Tensor, max_depth: int,
                           n_trees: torch.Tensor,
                           coeff: torch.Tensor = None) -> torch.Tensor:
    """K4: general (greedy) heap-walk ensemble sum -> [N, O] f32.

    X [N, F] f32; feat [T, 2^D-1] int32; thr [T, 2^D-1] f32; is_split
    [T, 2^D-1] bool; w [T, 2^D, O] f32 leaf values; n_trees int32 tensor
    (on the same device; trees at or beyond it contribute nothing); coeff
    [T, O] f32 scales each tree's leaf values (one rounded f32 product, as
    ``w * coeff[:, None, :]``), None when ``w`` is already scaled.  One
    launch for any shape."""
    if X.device.type == "cpu":
        return weighted_leaf_sum_plain(X, feat, thr, is_split, w, max_depth,
                                       n_trees, coeff)
    return _launch("gbrl_k4_leaf_sum", "weighted_leaf_sum", False, X, feat,
                   thr, is_split, w, max_depth, n_trees, coeff)


def oblivious_leaf_sum_cuda(X: torch.Tensor, feat: torch.Tensor,
                            thr: torch.Tensor, is_split: torch.Tensor,
                            w: torch.Tensor, max_depth: int,
                            n_trees: torch.Tensor,
                            coeff: torch.Tensor = None) -> torch.Tensor:
    """K5: oblivious-tree ensemble sum -> [N, O] f32 (same arguments as
    ``weighted_leaf_sum_cuda``); bit-identical to K4 on oblivious
    ensembles."""
    if X.device.type == "cpu":
        return oblivious_leaf_sum_plain(X, feat, thr, is_split, w, max_depth,
                                        n_trees, coeff)
    return _launch("gbrl_k5_leaf_sum", "oblivious_leaf_sum", True, X, feat,
                   thr, is_split, w, max_depth, n_trees, coeff)


# ================================================================ fit path
# K1-K3 (csrc/fit.cu).  Shared memory a K1 block may use; K3's need is set
# by O and the bucket count.
FIT_SMEM_BUDGET = 96 * 1024
HIST_MIN_TILE = 64
# K2's launch plan (fit.cu K2_WARPS, K2_SUB): warps per block, samples per
# staged sub-tile; HIST_FEATS features per slice; at most HIST_MAX_CLUSTER
# blocks (the portable cluster size) share a slice, each with at least
# HIST_MIN_TILE samples (above); a slice holds at most HIST_COL_CAP columns,
# so deep levels spread over more blocks; HIST_SMEM_BUDGET bytes per block
HIST_WARPS = 16
HIST_SUB = 512
HIST_FEATS = 4
HIST_MAX_CLUSTER = 8
HIST_COL_CAP = 4
HIST_SMEM_BUDGET = 160 * 1024
# K3's launch plan (fit.cu K3): at most SCORE_MAX_CLUSTER blocks (past the
# portable 8: a non-portable cluster size) share a node's or a level's
# features;
# SCORE_SMEM_BUDGET bytes per block
SCORE_MAX_CLUSTER = 16
SCORE_SMEM_BUDGET = 160 * 1024
# rows per chunk of the plain bucketize (bounds its [rows, F, B] compare)
PLAIN_BUCKETIZE_ELEMS = 1 << 22


def bucketize_plain(X: torch.Tensor, cand_vals: torch.Tensor) -> torch.Tensor:
    """K1's function in plain torch: ``out[n, f] = #{b : cand[f, b] <
    X[n, f]}`` as int32 (NaN counts 0)."""
    N, F = X.shape
    B = cand_vals.shape[1]
    out = torch.empty((N, F), dtype=torch.int32, device=X.device)
    rows = max(1, PLAIN_BUCKETIZE_ELEMS // max(1, F * B))
    for n0 in range(0, N, rows):
        x = X[n0:n0 + rows]
        out[n0:n0 + rows] = (cand_vals[None] < x[:, :, None]).sum(
            -1, dtype=torch.int32)
    return out


def level_histogram_plain(Xb: torch.Tensor, nd: torch.Tensor,
                          n_buckets: int) -> torch.Tensor:
    """K2's function in plain torch: ``hist[f, c, b] = sum_n [Xb[n, f] == b]
    * nd[n, c]`` -> [F, C, n_buckets] f32, one ``index_add_`` over the
    flattened (feature, bucket) ids.  Bucket ids outside [0, n_buckets)
    add nothing."""
    N, F = Xb.shape
    C = nd.shape[1]
    dev = Xb.device
    valid = (Xb >= 0) & (Xb < n_buckets)
    ids = (torch.arange(F, device=dev)[None, :] * n_buckets
           + Xb.long().clamp(0, max(n_buckets - 1, 0)))
    src = torch.where(valid[:, :, None], nd[:, None, :],
                      torch.zeros((), dtype=nd.dtype, device=dev))
    out = torch.zeros((F * n_buckets, C), dtype=torch.float32, device=dev)
    out.index_add_(0, ids.reshape(-1), src.reshape(N * F, C))
    return out.reshape(F, n_buckets, C).transpose(1, 2).contiguous()


def level_score_rows(hist: torch.Tensor, blocked: torch.Tensor,
                     feat_w: torch.Tensor, n_bins: int, out_dim: int,
                     score: str, min_data: int, oblivious: bool,
                     is_root: bool):
    """The candidate scores K3 chooses from, in plain torch: (rows
    [n_nodes, F * n_bins] greedy adjusted scores, or [1, F * n_bins] the
    oblivious level sums, NaN -> -inf; the tie band's extra base per row;
    node_cnt [n_nodes]; parent [n_nodes]; node_sum [n_nodes, O]).
    Arguments as ``level_score_plain``."""
    F, C, NB = hist.shape
    n_nodes = blocked.shape[0]
    O, B, K = out_dim, n_bins, out_dim + 1
    dev = hist.device
    h = hist.reshape(F, n_nodes, K, NB)
    cs = torch.empty_like(h)
    acc = torch.zeros_like(h[..., 0])
    for b in range(NB):
        acc = acc + h[..., b]
        cs[..., b] = acc
    tot = cs[0, :, :, NB - 1]                                # [n_nodes, K]
    ct = tot[:, O]
    sq = torch.zeros_like(ct)
    for o in range(O):
        sq = sq + tot[:, o] * tot[:, o]
    one = torch.ones((), dtype=torch.float32, device=dev)
    zero = torch.zeros((), dtype=torch.float32, device=dev)
    neg = torch.full((), float("-inf"), dtype=torch.float32, device=dev)
    p = torch.where(ct > 0, sq / torch.where(ct > 0, ct, one), zero)
    if score == "cosine":
        p = torch.where(p > 0, torch.sqrt(torch.where(p > 0, p, one)), zero)
    parent = torch.zeros_like(p) if is_root else p
    csn = cs.transpose(0, 1)                              # [n, F, K, NB]
    cl = csn[:, :, O, :B]
    cr = ct[:, None, None] - cl
    l2l = torch.zeros_like(cl)
    l2r = torch.zeros_like(cl)
    for o in range(O):
        lo = csn[:, :, o, :B]
        ro = tot[:, o][:, None, None] - lo
        l2l = l2l + lo * lo
        l2r = l2r + ro * ro
    sL = torch.where(cl > 0, l2l / torch.where(cl > 0, cl, one), zero)
    sR = torch.where(cr > 0, l2r / torch.where(cr > 0, cr, one), zero)
    s = sL + sR
    if score == "cosine":
        s = torch.where(s > 0, torch.sqrt(torch.where(s > 0, s, one)), zero)
    if min_data > 0:
        s = torch.where((cl < min_data) | (cr < min_data), neg, s)
    s = s * feat_w[None, :, None]                # -inf * 0 -> NaN -> -inf
    s = torch.where(blocked, neg, s).reshape(n_nodes, F * B)
    if oblivious:
        total = torch.zeros_like(s[0])
        for n in range(n_nodes):
            total = total + s[n]
        rows = torch.where(torch.isnan(total), neg, total)[None]
        scale = zero
    else:
        adj = s - parent[:, None]
        rows = torch.where(torch.isnan(adj), neg, adj)
        scale = parent.abs()[:, None]
    return rows, scale, ct, parent, tot[:, :O]


def level_score_plain(hist: torch.Tensor, blocked: torch.Tensor,
                      feat_w: torch.Tensor, n_bins: int, out_dim: int,
                      score: str, min_data: int, oblivious: bool,
                      is_root: bool):
    """K3's function in plain torch, with the kernel's arithmetic step for
    step (sequential f32 prefix sums over the buckets, products and sums in
    the same order), so on the same histogram the two agree bit for bit.

    hist [F, n_nodes * (O + 1), n_bins + 1] f32 (K2's layout: column
    node * (O + 1) + o, o == O the sample weights); blocked [n_nodes, F,
    n_bins] bool no-reuse mask; feat_w [F] f32.  Returns (best_idx
    [n_nodes] int32 merged index f * n_bins + b, best [n_nodes] f32 the
    adjusted score there, node_cnt [n_nodes], parent [n_nodes] (0 at the
    root), node_sum [n_nodes, O]).  Oblivious levels carry the level-summed
    argmax in every node."""
    rows, scale, ct, parent, sums = level_score_rows(
        hist, blocked, feat_w, n_bins, out_dim, score, min_data, oblivious,
        is_root)
    m = rows.max(dim=1, keepdim=True).values
    tol = torch.where(torch.isfinite(m), (m.abs() + scale) * 2e-6,
                      torch.zeros_like(m))
    idx = torch.argmax((rows >= m - tol).to(torch.uint8), dim=1)
    best = rows.gather(1, idx[:, None])[:, 0]
    best_idx = idx.to(torch.int32)
    n_nodes = blocked.shape[0]
    if oblivious:
        best_idx = best_idx.expand(n_nodes).contiguous()
        best = best.expand(n_nodes).contiguous()
    return best_idx, best, ct, parent, sums


def _fit_check(named: dict, want: dict) -> torch.device:
    dev = None
    for name, t in named.items():
        dt, nd = want[name]
        if (isinstance(t, torch.Tensor) and t.dtype == dt and t.dim() == nd
                and t.is_contiguous() and (dev is None or t.device == dev)):
            dev = dev or t.device
            continue
        dev = dev or getattr(t, "device", None)
        if not isinstance(t, torch.Tensor) or t.device != dev:
            raise ValueError(f"{name} must be a tensor on {dev}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if t.dtype != want[name][0]:
            raise ValueError(f"{name} must be {want[name][0]}, got {t.dtype}")
        if t.dim() != want[name][1]:
            raise ValueError(f"{name} must have {want[name][1]} dims, got "
                             f"{tuple(t.shape)}")
    return dev


def _index(dev: torch.device) -> int:
    return dev.index if dev.index is not None else torch.cuda.current_device()


@functools.lru_cache(maxsize=None)
def _smem_limit(index: int) -> int:
    """The most dynamic shared memory a block may opt in to on the device,
    queried once per device."""
    limit = _library().gbrl_max_smem_optin(index)
    if limit < 0:
        raise RuntimeError("cannot query the device's shared-memory limit")
    return limit


@functools.lru_cache(maxsize=None)
def _fit_ready(index: int) -> None:
    """Once per device: K1-K3 may use up to the device's opt-in shared
    memory, so no launch sets the attribute again."""
    lib = _library()
    with torch.cuda.device(index):
        rc = lib.gbrl_fit_prepare(_smem_limit(index))
    if rc != 0:
        raise RuntimeError(f"gbrl_fit_prepare failed: CUDA error {rc} "
                           f"({lib.gbrl_cuda_error_string(rc).decode()})")


def _smem_fits(dev: torch.device, need: int, what: str) -> None:
    limit = _smem_limit(_index(dev))
    if need > limit:
        raise ValueError(f"{what} needs {need} B of shared memory per block, "
                         f"more than the device's {limit} B")


def _call(lib, fn_name: str, dev: torch.device, *args) -> None:
    """One ctypes call that launches on ``dev``'s current stream (entering
    the device's context only when it is not the current device)."""
    index = _index(dev)
    stream = torch._C._cuda_getCurrentRawStream(index)
    if index == torch.cuda.current_device():
        rc = getattr(lib, fn_name)(*args, stream)
    else:
        with torch.cuda.device(index):
            rc = getattr(lib, fn_name)(*args, stream)
    if rc != 0:
        raise RuntimeError(f"{fn_name} failed: CUDA error {rc} "
                           f"({lib.gbrl_cuda_error_string(rc).decode()})")


@functools.lru_cache(maxsize=256)
def _bucketize_ready(index: int, F: int, B: int):
    """K1's (features per block, candidates per staged range), once per
    device and shape: whole candidate rows when one fits FIT_SMEM_BUDGET,
    else one feature per block with its candidates staged in ranges; checks
    the device's limit and readies the fit kernels."""
    bc = min(B, FIT_SMEM_BUDGET // 4 - 1)
    fc = min(F, FIT_SMEM_BUDGET // (4 * (bc + 1)))
    _smem_fits(torch.device("cuda", index), 4 * fc * (bc + 1), "bucketize")
    _fit_ready(index)
    return fc, bc


def bucketize_cuda(X: torch.Tensor, cand_vals: torch.Tensor) -> torch.Tensor:
    """K1: [N, F] f32 x [F, B] f32 -> [N, F] int32 bucket ids, the number of
    candidates strictly below x.  Each row must be ascending in the sense
    that ``cand[f, b] < x`` holds on a prefix of the row for every x: the
    kernel searches the row (a lower bound) where the plain version counts.
    Every grid the port builds is so (quantile and uniform, NaN last, +-inf
    and -0.0 / +0.0 included); a NaN x counts 0."""
    if X.device.type == "cpu":
        return bucketize_plain(X, cand_vals)
    dev = _fit_check(dict(X=X, cand_vals=cand_vals),
                     dict(X=(torch.float32, 2), cand_vals=(torch.float32, 2)))
    N, F = X.shape
    B = cand_vals.shape[1]
    if cand_vals.shape[0] != F or B < 1:
        raise ValueError(f"cand_vals must be [{F}, B >= 1], got "
                         f"{tuple(cand_vals.shape)}")
    lib = _library()
    out = torch.empty((N, F), dtype=torch.int32, device=dev)
    if N == 0 or F == 0:
        return out
    fc, bc = _bucketize_ready(_index(dev), F, B)
    _call(lib, "gbrl_k1_bucketize", dev, X.data_ptr(), cand_vals.data_ptr(),
          out.data_ptr(), N, F, B, fc, bc)
    _launched("bucketize")
    return out


class HistPlan(NamedTuple):
    """K2's launch plan: clusters of ``S`` blocks share a slice of ``fs``
    features x ``cs`` columns x ``br`` buckets, block r taking samples
    [r * tile, (r + 1) * tile); ``grid`` = (slices of features x S, column
    chunks, bucket ranges); ``smem`` bytes per block (fit.cu
    k2_smem_bytes)."""
    S: int
    tile: int
    fs: int
    cs: int
    br: int
    grid: tuple
    smem: int


def _hist_smem(fs: int, cs: int, br: int) -> int:
    hist = -(-(fs * cs * br) // 4) * 4          # padded for float4 reads
    return (4 * (hist + HIST_SUB * (cs + 1) + 32 * HIST_WARPS + cs
                 + HIST_SUB * fs) + 2 * HIST_SUB * cs)


@functools.lru_cache(maxsize=256)
def _hist_plan(N: int, F: int, C: int, n_buckets: int) -> HistPlan:
    """K2's launch plan from the shapes alone (never from the SM count, so
    the same inputs give the same bits on any card): the cluster grows by
    powers of two up to HIST_MAX_CLUSTER while each block keeps at least
    HIST_MIN_TILE samples; HIST_FEATS features a slice; as many columns (up
    to HIST_COL_CAP) as fit the budget with every bucket, else one column
    and bucket ranges that fit."""
    S = 1
    while S < HIST_MAX_CLUSTER and 2 * S * HIST_MIN_TILE <= N:
        S *= 2
    tile = max(1, -(-N // S))
    fs = min(F, HIST_FEATS)
    br = n_buckets
    cs = min(C, HIST_COL_CAP)
    while cs > 1 and _hist_smem(fs, cs, br) > HIST_SMEM_BUDGET:
        cs -= 1
    if _hist_smem(fs, cs, br) > HIST_SMEM_BUDGET:
        fixed = _hist_smem(fs, cs, 0)
        br = max(1, ((HIST_SMEM_BUDGET - fixed) // (4 * fs * cs)) // 4 * 4)
    grid = (-(-F // fs) * S, -(-C // cs), -(-n_buckets // br))
    return HistPlan(S, tile, fs, cs, br, grid, _hist_smem(fs, cs, br))


@functools.lru_cache(maxsize=256)
def _hist_ready(index: int, plan: HistPlan) -> None:
    """Once per device and plan: the grid's limits, the device's
    shared-memory limit, the fit kernels readied, and the cluster checked
    with the device (raises when it refuses it)."""
    if max(plan.grid[1:]) > 65535 or plan.grid[0] >= 1 << 31:
        raise ValueError(f"level_histogram: grid {plan.grid} too large")
    lib = _library()
    _smem_fits(torch.device("cuda", index), plan.smem, "level_histogram")
    _fit_ready(index)
    with torch.cuda.device(index):
        n = lib.gbrl_k2_max_clusters(plan.S, plan.fs, plan.cs, plan.br)
    if n < 1:
        raise RuntimeError(f"level_histogram: the device cannot run a "
                           f"cluster of {plan.S} blocks with {plan.smem} B of "
                           f"shared memory each (query returned {n})")


def level_histogram_cuda(Xb: torch.Tensor, nd: torch.Tensor,
                         n_buckets: int) -> torch.Tensor:
    """K2: [N, F] int32 bucket ids x [N, C] f32 rows -> [F, C, n_buckets]
    f32 with ``hist[f, c, b] = sum_n [Xb[n, f] == b] * nd[n, c]`` (bucket
    ids outside [0, n_buckets) add nothing).  The caller packs node-masked
    gradient columns into ``nd`` (C = n_nodes * (O + 1)).  One launch;
    deterministic: the same inputs give the same bits."""
    if Xb.device.type == "cpu":
        return level_histogram_plain(Xb, nd, n_buckets)
    dev = _fit_check(dict(Xb=Xb, nd=nd),
                     dict(Xb=(torch.int32, 2), nd=(torch.float32, 2)))
    N, F = Xb.shape
    C = nd.shape[1]
    if nd.shape[0] != N or n_buckets < 1:
        raise ValueError(f"nd must be [{N}, C] and n_buckets >= 1, got "
                         f"{tuple(nd.shape)}, {n_buckets}")
    lib = _library()
    if N == 0 or F == 0 or C == 0:
        return torch.zeros((F, C, n_buckets), dtype=torch.float32, device=dev)
    plan = _hist_plan(N, F, C, n_buckets)
    _hist_ready(_index(dev), plan)
    out = torch.empty((F, C, n_buckets), dtype=torch.float32, device=dev)
    _call(lib, "gbrl_k2_level_histogram", dev, Xb.data_ptr(), nd.data_ptr(),
          out.data_ptr(), N, F, C, n_buckets, plan.S, plan.tile, plan.fs,
          plan.cs, plan.br)
    _launched("level_histogram")
    return out


class ScorePlan(NamedTuple):
    """K3's launch plan: clusters of ``S`` blocks, one per node (greedy) or
    one for the level (oblivious); block r owns features [r * fpb, (r + 1)
    * fpb) and stages ``g`` features x ``nc`` nodes of histogram rows at a
    time; ``keep``: the block's candidate values stay in shared memory (else
    a second pass recomputes them); ``fuse``: the node totals are staged with
    the first group (else a first pass); ``glob``: the staged rows live in
    global scratch (``scratch`` floats), not in shared memory; ``smem``
    bytes per block (fit.cu k3_smem_words)."""
    S: int
    fpb: int
    g: int
    nc: int
    keep: int
    fuse: int
    glob: int
    scratch: int
    smem: int


def _score_rows(K: int, g: int, nc: int, fuse: int) -> int:
    """fit.cu k3_rows: the histogram rows a block stages at a time."""
    return nc * g * K + (nc * K if fuse else 0)


def _score_words(NB: int, K: int, B: int, NS: int, fpb: int, g: int, nc: int,
                 keep: int, fuse: int, glob: int = 0) -> int:
    """fit.cu k3_smem_words: staged rows at an odd stride (unless ``glob``:
    then in global scratch), node totals and parents, candidate values (all
    of the block's when ``keep``; else only an oblivious level's group sums
    when its nodes come in chunks), block scratch and the cluster
    exchange."""
    rows = 0 if glob else _score_rows(K, g, nc, fuse)
    vals = fpb * B if keep else g * B if nc < NS else 0
    return rows * (NB | 1) + NS * (K + 1) + vals + 36


@functools.lru_cache(maxsize=256)
def _score_plan(F: int, n_nodes: int, O: int, n_bins: int,
                oblivious: bool) -> ScorePlan:
    """K3's launch plan from the shapes alone: the features spread over up
    to SCORE_MAX_CLUSTER blocks; then the first of (keep, fuse), (keep, no
    fuse), (no keep, fuse), (no keep, no fuse) whose staging fits
    SCORE_SMEM_BUDGET once nodes per chunk and then features per group are
    halved as needed.  Where none fits (wide O), the staged rows go to
    global scratch: one (node, feature) a group, the node totals in a first
    pass, the block's candidate values kept in shared memory where they
    fit.  The result does not depend on the plan: every candidate's
    arithmetic is fixed and max / min are exact."""
    K, NB, B = O + 1, n_bins + 1, n_bins
    S = min(SCORE_MAX_CLUSTER, F)
    fpb = -(-F // S)
    S = -(-F // fpb)
    NS = n_nodes if oblivious else 1
    for keep, fuse in ((1, 1), (1, 0), (0, 1), (0, 0)):
        g, nc = fpb, NS

        def words():
            return _score_words(NB, K, B, NS, fpb, g, nc, keep, fuse)
        while 4 * words() > SCORE_SMEM_BUDGET and nc > 1:
            nc = -(-nc // 2)
        while 4 * words() > SCORE_SMEM_BUDGET and g > 1:
            g = -(-g // 2)
        if 4 * words() <= SCORE_SMEM_BUDGET:
            return ScorePlan(S, fpb, g, nc, keep, fuse, 0, 0, 4 * words())
    units = 1 if oblivious else n_nodes          # clusters: fit.cu k3_config
    keep = int(4 * _score_words(NB, K, B, NS, fpb, 1, 1, 1, 0, 1)
               <= SCORE_SMEM_BUDGET)
    return ScorePlan(S, fpb, 1, 1, keep, 0, 1,
                     units * S * _score_rows(K, 1, 1, 0) * (NB | 1),
                     4 * _score_words(NB, K, B, NS, fpb, 1, 1, keep, 0, 1))


@functools.lru_cache(maxsize=256)
def _score_params(index: int, F: int, n_nodes: int, O: int, n_bins: int,
                  cosine: bool, oblivious: bool, is_root: bool):
    """Once per device and shape: the plan, the device's shared-memory
    limit, the fit kernels readied and the cluster checked with the device
    (raises when it refuses it); returns (plan, fit.cu's K3 int array (Q_F
    ... Q_SMEM))."""
    plan = _score_plan(F, n_nodes, O, n_bins, oblivious)
    lib = _library()
    _smem_fits(torch.device("cuda", index), plan.smem, "level_score")
    _fit_ready(index)
    with torch.cuda.device(index):
        n = lib.gbrl_k3_max_clusters(plan.S, plan.smem)
    if n < 1:
        raise RuntimeError(f"level_score: the device cannot run a cluster of "
                           f"{plan.S} blocks with {plan.smem} B of shared "
                           f"memory each (query returned {n})")
    vals = [F, n_nodes, O, n_bins, int(cosine), int(oblivious), int(is_root),
            *plan[:7], plan.smem]
    return plan, (ctypes.c_int * len(vals))(*vals)


def level_score_cuda(hist: torch.Tensor, blocked: torch.Tensor,
                     feat_w: torch.Tensor, n_bins: int, out_dim: int,
                     score: str, min_data: int, oblivious: bool,
                     is_root: bool):
    """K3: one level's split choice from K2's histogram (arguments and
    results as ``level_score_plain``; the results are views of one packed
    buffer).  One launch."""
    if hist.device.type == "cpu":
        return level_score_plain(hist, blocked, feat_w, n_bins, out_dim,
                                 score, min_data, oblivious, is_root)
    dev = _fit_check(dict(hist=hist, blocked=blocked, feat_w=feat_w),
                     dict(hist=(torch.float32, 3), blocked=(torch.bool, 3),
                          feat_w=(torch.float32, 1)))
    F, C, NB = hist.shape
    n_nodes = blocked.shape[0]
    O = out_dim
    if (C != n_nodes * (O + 1) or NB != n_bins + 1
            or tuple(blocked.shape[1:]) != (F, n_bins)
            or feat_w.shape[0] != F or F < 1 or n_bins < 1):
        raise ValueError(
            f"level_score: hist {tuple(hist.shape)}, blocked "
            f"{tuple(blocked.shape)}, feat_w {tuple(feat_w.shape)} do not "
            f"fit n_bins={n_bins}, out_dim={O}")
    if n_nodes > 65535:
        raise ValueError(f"level_score takes at most 65535 nodes, got "
                         f"{n_nodes}")
    plan, params = _score_params(_index(dev), F, n_nodes, O, n_bins,
                                 score == "cosine", bool(oblivious),
                                 bool(is_root))
    out = torch.empty((O + 4, n_nodes), dtype=torch.float32, device=dev)
    scratch = (torch.empty(plan.scratch, dtype=torch.float32, device=dev)
               if plan.glob else None)
    _call(_library(), "gbrl_k3_level_score", dev, hist.data_ptr(),
          blocked.data_ptr(), feat_w.data_ptr(), out.data_ptr(),
          None if scratch is None else scratch.data_ptr(),
          ctypes.addressof(params), float(min_data))
    _launched("level_score")
    return out[0].view(torch.int32), out[1], out[2], out[3], out[4:].t()


# ============================================================== whole tree
# K6 (csrc/tree.cu): one thread-block cluster fits one numeric tree.
NPMAX = 8            # nodes per level K6 takes (tree.cu NPMAX): depth <= 4
TREE_LEAVES = 16     # leaves K6 takes (depth <= 4)
# the cluster grows by powers of two up to TREE_MAX_CLUSTER (past the
# portable 8: a non-portable size) while each rank keeps at least
# TREE_MIN_TILE samples; tree.cu K6_WARPS warps a block, TREE_SUB samples a
# staged sub-tile, at most TREE_MAX_GROUP features a histogram group; a
# rank's histogram of a group takes at most TREE_HIST_BUDGET bytes, its
# candidate values stay in shared memory up to TREE_SCORE_BUDGET bytes (else
# in global scratch), and a block at most TREE_SMEM_BUDGET bytes (the
# histogram budget halves until it fits)
TREE_MAX_CLUSTER = 16
TREE_MIN_TILE = 32
TREE_WARPS = 16
TREE_SUB = 256
TREE_MAX_GROUP = 16
TREE_HIST_BUDGET = 136 * 1024
TREE_SCORE_BUDGET = 32 * 1024
TREE_SMEM_BUDGET = 220 * 1024
# the layout's regions in tree.cu's order (P_PART ... P_SCR)
TREE_REGIONS = ("part", "red", "sc", "slot", "v", "xb", "rel", "list", "cnt",
                "totown", "tot", "xch", "choice", "leaf", "shf", "shi", "scr")


def _tree_cluster(N: int) -> int:
    """K6's cluster size: it grows by powers of two up to TREE_MAX_CLUSTER
    while each rank keeps at least TREE_MIN_TILE samples."""
    S = 1
    while S < TREE_MAX_CLUSTER and 2 * S * TREE_MIN_TILE <= N:
        S *= 2
    return S


def _tree_tiling(N: int, F: int):
    """K6's sample tiles -> (samples per tile, tiles): one tile per rank of
    the cluster (F does not enter; ranks past the last tile take none).  The
    plain version takes the same tiles, since they set its summation
    order."""
    tile = max(1, -(-N // _tree_cluster(N)))
    return tile, -(-N // tile)


class TreePlan(NamedTuple):
    """K6's launch plan: a cluster of ``S`` blocks, rank r taking samples
    [r * tile, (r + 1) * tile); ``g[d]`` features per histogram group at
    level d; ``slots`` candidate rows per rank; ``part`` floats of a rank's
    histograms and ``red`` floats of its reduced rows; ``sc_global``,
    ``part_global``, ``red_global``: those regions kept in global scratch
    (``scratch`` floats in all) where shared memory cannot hold them;
    ``gmax`` the largest group; ``offsets`` of the shared memory's regions
    (TREE_REGIONS, in floats); ``smem`` bytes per block."""
    S: int
    tile: int
    g: tuple
    slots: int
    part: int
    red: int
    sc_global: int
    part_global: int
    red_global: int
    scratch: int
    gmax: int
    offsets: tuple
    smem: int


def _tree_layout(K: int, B: int, part: int, red: int, sc: int, slots: int,
                 gmax: int):
    """(offsets in floats, total bytes) of tree.cu's shared-memory regions
    (``part``, ``red``, ``sc``: floats held in shared memory)."""
    sizes = dict(part=part, red=red, sc=sc, slot=2 * slots,
                 v=TREE_SUB * (K | 1), xb=TREE_SUB * (gmax | 1), rel=TREE_SUB,
                 list=TREE_LEAVES * TREE_SUB // 2, cnt=TREE_LEAVES,
                 totown=NPMAX * K, tot=NPMAX * (K + 1), xch=6 * NPMAX,
                 choice=8 * NPMAX, leaf=TREE_LEAVES * K,
                 shf=TREE_WARPS * NPMAX, shi=TREE_WARPS * NPMAX,
                 scr=TREE_WARPS * 32)
    offsets, at = [], 0
    for name in TREE_REGIONS:
        offsets.append(at)
        at += -(-sizes[name] // 4) * 4          # 16-byte aligned regions
    return tuple(offsets), 4 * at


@functools.lru_cache(maxsize=256)
def _tree_plan(N: int, F: int, O: int, n_bins: int, D: int,
               oblivious: bool) -> TreePlan:
    """K6's launch plan from the shapes alone: the tiling, then per level
    the features per group (as many as TREE_HIST_BUDGET holds, at most
    TREE_MAX_GROUP, spread evenly over the groups), the units each rank owns
    (round robin: (feature, node) pairs, or features with all their nodes
    when oblivious), its candidate rows, and the layout."""
    S = _tree_cluster(N)
    tile = _tree_tiling(N, F)[0]
    K, NB, B = O + 1, n_bins + 1, n_bins
    NBq = -(-NB // 4) * 4                       # part's float4-aligned rows
    budget = TREE_HIST_BUDGET // 4
    while True:
        g, part, red_rows, slots = [], 0, 0, 0
        for d in range(D):
            nact = 1 << d
            Cd = nact * K
            fit = max(1, min(F, TREE_MAX_GROUP, budget // (Cd * NBq)))
            n_groups = -(-F // fit)
            gd = -(-F // n_groups)
            g.append(gd)
            part = max(part, gd * Cd * NBq)
            nu = 1 if oblivious else nact
            red_rows = max(red_rows, -(-gd * nu // S)
                           * (nact if oblivious else 1) * K)
            slots = max(slots, sum(-(-min(gd, F - ga) * nu // S)
                                   for ga in range(0, F, gd)))
        red = red_rows * (NB | 1)
        sc_global = int(4 * slots * B > TREE_SCORE_BUDGET)
        glob = [sc_global, 0, 0]
        offsets, smem = _tree_layout(K, B, part, red, 0 if sc_global else
                                     slots * B, slots, max(g))
        if smem <= TREE_SMEM_BUDGET or budget < NBq * K:
            break
        budget //= 2
    # past the budget even at one feature a group (large O): the ranks'
    # histograms, then the reduced rows, go to global scratch
    for i in (1, 2):
        if smem > TREE_SMEM_BUDGET:
            glob[i] = 1
            offsets, smem = _tree_layout(
                K, B, 0 if glob[1] else part, 0 if glob[2] else red,
                0 if sc_global else slots * B, slots, max(g))
    sizes = (slots * B, part, red)
    scratch = S * sum(-(-n // 4) * 4 for n, on in zip(sizes, glob) if on)
    return TreePlan(S, tile, tuple(g + [0] * (4 - D)), slots, part, red,
                    *glob, scratch, max(g), offsets, smem)


@functools.lru_cache(maxsize=256)
def _tree_params(index: int, N: int, F: int, B: int, O: int, D: int,
                 cosine: bool, oblivious: bool):
    """Once per device and shape: the plan, the device's shared-memory
    limit, K6's attribute set and its cluster checked with the device
    (raises when it refuses it); returns (plan, tree.cu's int array P_N ...
    P_SMEM)."""
    plan = _tree_plan(N, F, O, B, D, oblivious)
    lib = _library()
    _smem_fits(torch.device("cuda", index), plan.smem, "tree_build")
    with torch.cuda.device(index):
        rc = lib.gbrl_k6_prepare(_smem_limit(index))
        if rc != 0:
            raise RuntimeError(f"gbrl_k6_prepare failed: CUDA error {rc} "
                               f"({lib.gbrl_cuda_error_string(rc).decode()})")
        n = lib.gbrl_k6_max_clusters(plan.S, plan.smem)
    if n < 1:
        raise RuntimeError(f"tree_build: the device cannot run a cluster of "
                           f"{plan.S} blocks with {plan.smem} B of shared "
                           f"memory each (query returned {n})")
    vals = ([N, F, B, O, D, int(cosine), int(oblivious), plan.S, plan.tile]
            + list(plan.g) + [plan.slots, plan.sc_global, plan.part_global,
                              plan.red_global, plan.part, plan.red,
                              plan.gmax] + list(plan.offsets) + [plan.smem])
    return plan, (ctypes.c_int * len(vals))(*vals)


def _tile_sums(idx: torch.Tensor, vals: torch.Tensor, n_idx: int,
               tile: int) -> torch.Tensor:
    """``out[t, j, c, i]`` = the sum, over the samples n of tile t in
    increasing order, of ``vals[n, c]`` where ``idx[n, j] == i`` (ids outside
    [0, n_idx) add nothing): idx [N, J] int, vals [N, C] -> [n_tiles, J, C,
    n_idx].  One scatter per position in the tile, each destination taking
    one term, so every sum has K6's order on any device."""
    N, J = idx.shape
    C = vals.shape[1]
    n_tiles = -(-N // tile)
    pad = n_tiles * tile - N
    valid = (idx >= 0) & (idx < n_idx)
    ii = torch.where(valid, idx.long(), torch.zeros_like(idx, dtype=torch.long))
    v = torch.where(valid[:, :, None], vals[:, None, :],
                    torch.zeros((), dtype=vals.dtype, device=vals.device))
    if pad:
        ii = torch.cat([ii, ii.new_zeros((pad, J))])
        v = torch.cat([v, v.new_zeros((pad, J, C))])
    ii = ii.reshape(n_tiles, tile, J)
    v = v.reshape(n_tiles, tile, J, C)
    out = torch.zeros((n_tiles, J, C, n_idx), dtype=torch.float32,
                      device=vals.device)
    for s in range(tile):
        out.scatter_add_(3, ii[:, s, :, None, None].expand(n_tiles, J, C, 1),
                         v[:, s, :, :, None])
    return out


def _sum_tiles(part: torch.Tensor) -> torch.Tensor:
    """Sum over the leading (tile) dimension in tile order, from +0."""
    acc = torch.zeros(part.shape[1:], dtype=part.dtype, device=part.device)
    for t in range(part.shape[0]):
        acc = acc + part[t]
    return acc


def tree_build_plain(Xb: torch.Tensor, cand: torch.Tensor,
                     feat_w: torch.Tensor, bgw: torch.Tensor, wg: torch.Tensor,
                     max_depth: int, n_bins: int, out_dim: int, score: str,
                     min_data: int, oblivious: bool, tile: int):
    """K6's function in plain torch, with the kernel's summation order:
    histograms and leaf sums per sample tile in sample order, then over the
    tiles in tile order; each level's scores and choice as K3's plain
    version (``level_score_plain``).  Arguments and results as
    ``tree_build_cuda``, plus the tile size that sets the order."""
    N, F = Xb.shape
    B, O, D = n_bins, out_dim, max_depth
    K = O + 1
    dev = Xb.device
    best_idx = torch.zeros((D, NPMAX), dtype=torch.int32, device=dev)
    do_split = torch.zeros((D, NPMAX), dtype=torch.bool, device=dev)
    stats = torch.zeros((D, NPMAX, O + 3), dtype=torch.float32, device=dev)
    rel = torch.zeros((N,), dtype=torch.long, device=dev)
    blocked = torch.zeros((1, F, B), dtype=torch.bool, device=dev)
    alive = torch.ones((), dtype=torch.bool, device=dev)
    zero = torch.zeros((), dtype=torch.float32, device=dev)
    for d in range(D):
        nact = 1 << d
        own = rel[:, None] == torch.arange(nact, device=dev)[None, :]
        nd = torch.where(own[:, :, None], bgw[:, None, :], zero
                         ).reshape(N, nact * K)
        hist = _sum_tiles(_tile_sums(Xb, nd, B + 1, tile))
        bi, best, ct, parent, sums = level_score_plain(
            hist, blocked, feat_w, B, O, score, min_data, oblivious, d == 0)
        if oblivious:
            alive = alive & (best[0] > float("-inf"))
            split = alive.expand(nact)
        else:
            split = (best >= 0) & (ct > 0)
        best_idx[d, :nact] = bi
        do_split[d, :nact] = split
        stats[d, :nact] = torch.cat([best[:, None], ct[:, None],
                                     parent[:, None], sums], dim=1)
        f_sel = (bi // B).long()
        b_sel = bi % B
        x = torch.gather(Xb, 1, f_sel[rel][:, None])[:, 0]
        rel = 2 * rel + (split[rel] & (x > b_sel[rel])).long()
        v_sel = cand[f_sel, b_sel.long()]
        chosen = (split[:, None, None]
                  & (f_sel[:, None, None]
                     == torch.arange(F, device=dev)[None, :, None])
                  & (v_sel[:, None, None] == cand[None, :, :]))
        blocked = (blocked | chosen)[torch.arange(2 * nact, device=dev) // 2]
    leaf = _sum_tiles(_tile_sums(rel[:, None], wg, 1 << D, tile))[0].T
    return best_idx, do_split, stats, leaf.contiguous()


def tree_build_cuda(Xb: torch.Tensor, cand: torch.Tensor, feat_w: torch.Tensor,
                    bgw: torch.Tensor, wg: torch.Tensor, max_depth: int,
                    n_bins: int, out_dim: int, score: str, min_data: int,
                    oblivious: bool):
    """K6: one numeric tree of depth ``max_depth`` <= 4 in one launch.

    Xb [N, F] int32 bucket ids in [0, n_bins]; cand [F, n_bins] f32
    ascending; feat_w [F] f32; bgw [N, O + 1] (scoring gradients * w | w)
    and wg [N, O + 1] (raw gradients * w | w) f32.  Returns per level d and
    node n < NPMAX (nodes past the level's 2^d zero): best_idx [D, NPMAX]
    int32 (f * n_bins + b), do_split [D, NPMAX] bool, stats [D, NPMAX,
    O + 3] f32 (best score, node count, parent score, node sums [O]), and
    leaf [2^D, O + 1] f32, the wg sums of each leaf.  Deterministic: the
    same inputs give the same bits, equal to ``tree_build_plain``'s at
    ``_tree_tiling``'s tile."""
    N, F = Xb.shape
    tile = _tree_tiling(N, F)[0]
    args = (Xb, cand, feat_w, bgw, wg, max_depth, n_bins, out_dim, score,
            min_data, oblivious)
    if Xb.device.type == "cpu":
        return tree_build_plain(*args, tile)
    dev = _fit_check(dict(Xb=Xb, cand=cand, feat_w=feat_w, bgw=bgw, wg=wg),
                     dict(Xb=(torch.int32, 2), cand=(torch.float32, 2),
                          feat_w=(torch.float32, 1), bgw=(torch.float32, 2),
                          wg=(torch.float32, 2)))
    B, O, D = n_bins, out_dim, max_depth
    K = O + 1
    if (tuple(cand.shape) != (F, B) or feat_w.shape[0] != F or F < 1
            or B < 1 or tuple(bgw.shape) != (N, K)
            or tuple(wg.shape) != (N, K)):
        raise ValueError(
            f"tree_build: Xb {tuple(Xb.shape)}, cand {tuple(cand.shape)}, "
            f"feat_w {tuple(feat_w.shape)}, bgw {tuple(bgw.shape)}, wg "
            f"{tuple(wg.shape)} do not fit n_bins={B}, out_dim={O}")
    if not 1 <= D or (1 << (D - 1)) > NPMAX:
        raise ValueError(f"tree_build takes depths 1 to 4, got {D}")
    plan, params = _tree_params(_index(dev), N, F, B, O, D,
                                score == "cosine", bool(oblivious))
    # one allocation: best_idx (int32) | stats | leaf (f32) | do_split (u8)
    sizes = [D * NPMAX, D * NPMAX * (O + 3), (1 << D) * K, -(-D * NPMAX // 4)]
    out = torch.empty((sum(sizes),), dtype=torch.float32, device=dev)
    idx, stats, leaf, split = out.split(sizes)
    scg = (torch.empty((plan.scratch,), dtype=torch.float32, device=dev)
           if plan.scratch else out)
    _call(_library(), "gbrl_k6_tree_build", dev, Xb.data_ptr(),
          cand.data_ptr(), feat_w.data_ptr(), bgw.data_ptr(), wg.data_ptr(),
          scg.data_ptr(), idx.data_ptr(), split.data_ptr(), stats.data_ptr(),
          leaf.data_ptr(), ctypes.addressof(params), float(min_data))
    _launched("tree_build")
    return (idx.view(torch.int32).view(D, NPMAX),
            split.view(torch.bool)[:D * NPMAX].view(D, NPMAX),
            stats.view(D, NPMAX, O + 3), leaf.view(1 << D, K))
