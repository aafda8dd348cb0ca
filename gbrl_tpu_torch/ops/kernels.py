"""Hand-written CUDA predict kernels (K4, K5) and their plain PyTorch versions.

Counterpart of ``gbrl_tpu/ops/pallas_kernels.py`` for the predict path:

- ``weighted_leaf_sum_cuda``  replaces ``weighted_leaf_sum_pallas`` (K4);
- ``oblivious_leaf_sum_cuda`` replaces ``oblivious_leaf_sum_pallas`` (K5).

Both compute ``sum_{t < n_trees} w[t, leaf(n, t), :] -> [N, O]`` with
``w = leaf_values * coeff`` already folded.  The CUDA sources live in
``gbrl_tpu_torch/csrc/predict.cu``; they are compiled at first use with
``nvcc`` into a shared library with a C interface, keyed by a hash of the
sources and flags, and loaded with ``ctypes``.  The library goes under
``build/gbrl_tpu_torch_kernels/`` at the root of a source checkout, under
``$GBRL_TPU_TORCH_BUILD_DIR`` if that is set, and otherwise (an installed
package) under ``$XDG_CACHE_HOME`` or ``~/.cache``, in
``gbrl_tpu_torch_kernels/``.

A wrapper given CPU tensors runs the plain version.  Given CUDA tensors it
launches the kernel or raises: it never falls back.  Each wrapper counts its
kernel launches in ``launch_counts`` (the CPU branch does not count).
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
from typing import Callable, Union

import torch

CSRC = Path(__file__).resolve().parent.parent / "csrc"
SOURCES = ("predict.cu",)
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-O3", "-std=c++17",
              "-shared", "-Xcompiler", "-fPIC")
BUILD_NAME = "gbrl_tpu_torch_kernels"

# trees staged per shared-memory chunk: at most this many, fewer when the
# block's shared memory would exceed SMEM_BUDGET (deep trees / wide F), down
# to the warp group (8) within the device's opt-in shared-memory maximum
MAX_CHUNK = 128
SMEM_BUDGET = 100 * 1024
PLAIN_TREE_CHUNK = 512

launch_counts = {"weighted_leaf_sum": 0, "oblivious_leaf_sum": 0}


def reset_launch_counts() -> None:
    for k in launch_counts:
        launch_counts[k] = 0


# ------------------------------------------------------------ plain versions
def _live(n_trees: Union[int, torch.Tensor], capacity: int) -> int:
    return max(0, min(int(n_trees), capacity))


def _leaf_sum_plain(leaf_fn: Callable, X: torch.Tensor, w: torch.Tensor,
                    n_trees) -> torch.Tensor:
    """Shared summation of both plain versions: trees in chunks of
    PLAIN_TREE_CHUNK, ``leaf_fn(t0, t1) -> [N, t1 - t0]`` leaf indices.  Only
    the leaf indices differ between K4 and K5, so on an oblivious ensemble
    the two plain versions give the same bits."""
    N = X.shape[0]
    O = w.shape[-1]
    nt = _live(n_trees, w.shape[0])
    acc = torch.zeros((N, O), dtype=torch.float32, device=X.device)
    for t0 in range(0, nt, PLAIN_TREE_CHUNK):
        t1 = min(nt, t0 + PLAIN_TREE_CHUNK)
        leaf = leaf_fn(t0, t1)                                  # [N, C]
        trees = torch.arange(t0, t1, device=X.device)[None, :]
        acc = acc + w[trees, leaf].sum(dim=1)                   # [N, C, O]
    return acc


def weighted_leaf_sum_plain(X: torch.Tensor, feat: torch.Tensor,
                            thr: torch.Tensor, is_split: torch.Tensor,
                            w: torch.Tensor, max_depth: int,
                            n_trees) -> torch.Tensor:
    """K4's function in plain torch: direct heap walk ``p = 2p + 1 + go``
    with ``go = is_split & (x[max(feat, 0)] > thr)``."""
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

    return _leaf_sum_plain(leaf_fn, X, w, n_trees)


def oblivious_leaf_sum_plain(X: torch.Tensor, feat: torch.Tensor,
                             thr: torch.Tensor, is_split: torch.Tensor,
                             w: torch.Tensor, max_depth: int,
                             n_trees) -> torch.Tensor:
    """K5's function in plain torch: one (feat, thr, is_split) per level,
    read at the level-lead slot ``2^d - 1``, packed into a leaf bit index."""
    lead = [(1 << d) - 1 for d in range(max_depth)]

    def leaf_fn(t0, t1):
        leaf = torch.zeros((X.shape[0], t1 - t0), dtype=torch.long,
                           device=X.device)
        for d in lead:
            f = feat[t0:t1, d].long().clamp_(min=0)
            go = is_split[t0:t1, d][None, :] & (X[:, f] > thr[t0:t1, d][None, :])
            leaf = 2 * leaf + go.long()
        return leaf

    return _leaf_sum_plain(leaf_fn, X, w, n_trees)


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
    raise RuntimeError("nvcc not found: the CUDA predict kernels cannot be "
                       "built (set CUDA_HOME)")


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
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name in SOURCES:
        h.update(name.encode())
        h.update((CSRC / name).read_bytes())
    return h.hexdigest()[:16]


def build_library() -> Path:
    """Compile the sources into ``build_dir()/<hash>/libgbrl_predict.so``
    unless that file exists; returns its path.  The library is written to a
    temporary name and renamed, so concurrent builders never load a partial
    file."""
    out_dir = build_dir() / _source_key()
    lib = out_dir / "libgbrl_predict.so"
    if lib.exists():
        return lib
    out_dir.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=out_dir)
    os.close(fd)
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp,
           *[str(CSRC / name) for name in SOURCES]]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError("nvcc failed building the predict kernels:\n"
                           + " ".join(cmd) + "\n" + proc.stdout + proc.stderr)
    os.replace(tmp, lib)
    return lib


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    lib = ctypes.CDLL(str(build_library()))
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    for name in ("gbrl_k4_leaf_sum", "gbrl_k5_leaf_sum"):
        fn = getattr(lib, name)
        fn.argtypes = [ptr] * 7 + [i32] * 6 + [ptr]
        fn.restype = i32
    lib.gbrl_leaf_sum_smem_bytes.argtypes = [i32] * 5
    lib.gbrl_leaf_sum_smem_bytes.restype = ctypes.c_size_t
    lib.gbrl_leaf_sum_group.argtypes = []
    lib.gbrl_leaf_sum_group.restype = i32
    lib.gbrl_max_smem_optin.argtypes = [i32]
    lib.gbrl_max_smem_optin.restype = i32
    lib.gbrl_cuda_error_string.argtypes = [i32]
    lib.gbrl_cuda_error_string.restype = ctypes.c_char_p
    return lib


# ---------------------------------------------------------------- wrappers
def _check(X, feat, thr, is_split, w, max_depth, n_trees) -> None:
    dev = X.device
    named = dict(X=X, feat=feat, thr=thr, is_split=is_split, w=w,
                 n_trees=n_trees)
    for name, t in named.items():
        if not isinstance(t, torch.Tensor) or t.device != dev:
            raise ValueError(f"{name} must be a tensor on {dev}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    want = dict(X=torch.float32, feat=torch.int32, thr=torch.float32,
                is_split=torch.bool, w=torch.float32, n_trees=torch.int32)
    for name, dt in want.items():
        if named[name].dtype != dt:
            raise ValueError(f"{name} must be {dt}, got {named[name].dtype}")
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
    if n_trees.numel() != 1:
        raise ValueError("n_trees must hold one int32")


def _chunk(lib, device: torch.device, F: int, K: int, max_depth: int,
           O: int) -> int:
    """Largest power-of-two chunk <= MAX_CHUNK (and >= the warp group) whose
    shared memory fits SMEM_BUDGET; the warp group alone when only the
    device's opt-in maximum fits it.  Raises when even that does not fit:
    the kernel cannot take such a shape, and a CUDA tensor never falls back
    to the plain version."""
    group = lib.gbrl_leaf_sum_group()
    C = MAX_CHUNK
    while C > group and lib.gbrl_leaf_sum_smem_bytes(F, C, K, max_depth,
                                                      O) > SMEM_BUDGET:
        C //= 2
    need = lib.gbrl_leaf_sum_smem_bytes(F, C, K, max_depth, O)
    limit = lib.gbrl_max_smem_optin(device.index if device.index is not None
                                    else torch.cuda.current_device())
    if limit < 0:
        raise RuntimeError("cannot query the device's shared-memory limit")
    if need > limit:
        raise ValueError(
            f"the predict kernel needs {need} B of shared memory per block "
            f"at F={F}, depth={max_depth}, O={O} (chunk of {C} trees), more "
            f"than the device's {limit} B")
    return C


def _launch(fn_name: str, count_key: str, K: int, X, feat, thr, is_split, w,
            max_depth: int, n_trees) -> torch.Tensor:
    _check(X, feat, thr, is_split, w, max_depth, n_trees)
    lib = _library()
    N, F = X.shape
    O = w.shape[-1]
    out = torch.empty((N, O), dtype=torch.float32, device=X.device)
    if N == 0 or O == 0:
        return out
    C = _chunk(lib, X.device, F, K, max_depth, O)
    with torch.cuda.device(X.device):
        stream = torch.cuda.current_stream(X.device).cuda_stream
        rc = getattr(lib, fn_name)(
            X.data_ptr(), feat.data_ptr(), thr.data_ptr(), is_split.data_ptr(),
            w.data_ptr(), n_trees.data_ptr(), out.data_ptr(), N, F,
            feat.shape[0], max_depth, O, C, stream)
    if rc != 0:
        raise RuntimeError(f"{fn_name} failed: CUDA error {rc} "
                           f"({lib.gbrl_cuda_error_string(rc).decode()})")
    launch_counts[count_key] += 1
    return out


def weighted_leaf_sum_cuda(X: torch.Tensor, feat: torch.Tensor,
                           thr: torch.Tensor, is_split: torch.Tensor,
                           w: torch.Tensor, max_depth: int,
                           n_trees: torch.Tensor) -> torch.Tensor:
    """K4: general (greedy) heap-walk ensemble sum -> [N, O] f32.

    X [N, F] f32; feat [T, 2^D-1] int32; thr [T, 2^D-1] f32; is_split
    [T, 2^D-1] bool; w [T, 2^D, O] f32; n_trees int32 tensor (on the same
    device; trees at or beyond it contribute nothing)."""
    if X.device.type == "cpu":
        return weighted_leaf_sum_plain(X, feat, thr, is_split, w, max_depth,
                                       n_trees)
    return _launch("gbrl_k4_leaf_sum", "weighted_leaf_sum",
                   (1 << max_depth) - 1, X, feat, thr, is_split, w,
                   max_depth, n_trees)


def oblivious_leaf_sum_cuda(X: torch.Tensor, feat: torch.Tensor,
                            thr: torch.Tensor, is_split: torch.Tensor,
                            w: torch.Tensor, max_depth: int,
                            n_trees: torch.Tensor) -> torch.Tensor:
    """K5: oblivious-tree ensemble sum -> [N, O] f32 (same arguments as
    ``weighted_leaf_sum_cuda``); bit-identical to K4 on oblivious
    ensembles."""
    if X.device.type == "cpu":
        return oblivious_leaf_sum_plain(X, feat, thr, is_split, w, max_depth,
                                        n_trees)
    return _launch("gbrl_k5_leaf_sum", "oblivious_leaf_sum", max_depth, X,
                   feat, thr, is_split, w, max_depth, n_trees)
