"""Host-resident ensemble mirror for rollout forwards (counterpart of
``gbrl_tpu/utils/host_mirror.py``).

RL rollouts call ``predict`` on tiny batches (n_envs observations) once per
environment step.  Each such call on the card pays a host-to-device copy,
a dozen launches and a device-to-host copy, while the card's strength, the
update phase's histograms and fits on thousands of samples, idles during
rollouts anyway.

This module keeps an incrementally synced host copy of the ensemble (only
the NEW trees are copied from the card after each update phase) and serves
predictions from a small C predictor, ``csrc/mirror.c``, built with ``gcc``
at first use into the port's build directory (``ops.kernels.build_dir()``),
keyed by a hash of the source.  A build that fails raises; only a host with
no C compiler at all serves from the numpy walk below.  As the reference's
``Predictor::predict_cpu`` (predictor.cpp:122-184), it walks heap trees on
the host; leaf values are pre-multiplied by the optimizer coefficients
-lr_o(t) (optimizer.cpp:110-118, scheduler.h:124-133), so a prediction is
``bias + sum_t wleaf[t, leaf(x, t), :]``; Adam columns run the moment
recurrence per sample (optimizer.cpp:260-283).

Exactness: leaf values are immutable once fit and SGD coefficients depend
only on the tree index, so the mirror reproduces the device predict's
semantics; the float32 summation order differs (tree-major here), giving
~1e-6-level differences.
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
from typing import Optional

import numpy as np

from ..ops.kernels import CSRC, build_dir
from . import profiling

MIRROR_SRC = CSRC / "mirror.c"
MIRROR_LIB = "libgbrl_mirror.so"
# dims of the Adam predictor's per-sample moment arrays (mirror.c)
ADAM_MAX_OUTPUTS = 256
# the ensemble fields a sync copies to the host, one ``.cpu()`` each
TREE_FIELDS = ("feat", "thr", "is_split", "is_numeric", "cat_code",
               "leaf_values")


def _compiler() -> Optional[str]:
    return shutil.which("gcc") or shutil.which("cc")


def build_mirror_library() -> Optional[Path]:
    """Compile ``csrc/mirror.c`` into ``build_dir()/mirror-<hash>/`` unless
    it is there; returns its path, or None on a host with no C compiler.
    A compiler error raises."""
    cc = _compiler()
    if cc is None:
        return None
    src = MIRROR_SRC.read_bytes()
    out_dir = build_dir() / f"mirror-{hashlib.sha256(src).hexdigest()[:16]}"
    lib = out_dir / MIRROR_LIB
    if lib.exists():
        return lib
    out_dir.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=out_dir) as tmp:
        tmp_lib = os.path.join(tmp, MIRROR_LIB)
        proc = subprocess.run([cc, "-O2", "-shared", "-fPIC", str(MIRROR_SRC),
                               "-o", tmp_lib, "-lm"], capture_output=True,
                              text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"{cc} failed building {MIRROR_SRC}:\n"
                               + proc.stdout + proc.stderr)
        os.replace(tmp_lib, lib)
    return lib


@functools.lru_cache(maxsize=None)
def _load_lib() -> Optional[ctypes.CDLL]:
    path = build_mirror_library()
    if path is None:
        return None
    lib = ctypes.CDLL(str(path))
    lib.gbrl_mirror_predict.restype = None
    lib.gbrl_mirror_predict_adam.restype = None
    return lib


def _ptr(a: np.ndarray) -> ctypes.c_void_p:
    return a.ctypes.data_as(ctypes.c_void_p)


def _host_lr(spec, t: np.ndarray) -> np.ndarray:
    """lr_o(t) for tree indices t: host replica of
    ``optimizers.scheduler_lr`` (scheduler.h:124-133, 182-185)."""
    if spec.scheduler == "Linear":
        lr = (spec.init_lr
              + ((t + 1.0) / np.float32(spec.T))
              * (spec.stop_lr - spec.init_lr)).astype(np.float32)
        return np.where(lr < spec.stop_lr, np.float32(spec.stop_lr), lr)
    return np.full_like(t, spec.init_lr)


def _host_sgd_coeff(specs, t0: int, t1: int, output_dim: int) -> np.ndarray:
    """-lr_o(t) on each optimizer's column range for trees [t0, t1): host
    replica of ``optimizers.sgd_coeff``."""
    t = np.arange(t0, t1, dtype=np.float32)
    coeff = np.zeros((t1 - t0, output_dim), dtype=np.float32)
    for s in specs:
        lr = _host_lr(s, t)
        stop = s.stop_idx if s.stop_idx else output_dim
        coeff[:, s.start_idx:stop] -= lr[:, None]
    return coeff


class HostMirror:
    """Incrementally synced host copy of a GBTLearner's ensemble.

    Usage::

        mirror = HostMirror(learner)
        ...
        mirror.sync()                 # after each update phase: new trees
        preds = mirror.predict(obs)   # [N, O] numpy, on the host
    """

    def __init__(self, learner):
        self.learner = learner
        self.has_adam = any(s.algo == "Adam" for s in learner.specs)
        cfg = learner.cfg
        self.D = cfg.max_depth
        self.P = (1 << self.D) - 1
        self.L = 1 << self.D
        self.O = cfg.output_dim
        self.n_synced = 0
        # per-column Adam hyperparameters for the C predictor (columns
        # partition among optimizers: one Adam spec at most per column)
        self.adam_mask = np.zeros(self.O, dtype=np.uint8)
        self.ab1 = np.zeros(self.O, dtype=np.float32)
        self.ab2 = np.zeros(self.O, dtype=np.float32)
        self.aeps = np.zeros(self.O, dtype=np.float32)
        for s in learner.specs:
            if s.algo == "Adam":
                stop = s.stop_idx if s.stop_idx else self.O
                self.adam_mask[s.start_idx:stop] = 1
                self.ab1[s.start_idx:stop] = s.beta_1
                self.ab2[s.start_idx:stop] = s.beta_2
                self.aeps[s.start_idx:stop] = s.eps
        self._alloc(256)
        self.bias = np.zeros(self.O, dtype=np.float32)
        self.sync()

    @property
    def uses_c_library(self) -> bool:
        """Whether predictions come from the C predictor (else numpy)."""
        return _load_lib() is not None and not (
            self.has_adam and self.O > ADAM_MAX_OUTPUTS)

    def _alloc(self, cap: int):
        self.cap = cap
        self.feat = np.zeros((cap, self.P), dtype=np.int32)
        self.thr = np.zeros((cap, self.P), dtype=np.float32)
        self.split = np.zeros((cap, self.P), dtype=np.uint8)
        self.isnum = np.ones((cap, self.P), dtype=np.uint8)
        self.code = np.full((cap, self.P), -1, dtype=np.int32)
        self.wleaf = np.zeros((cap, self.L, self.O), dtype=np.float32)
        self.raw_leaf = (np.zeros((cap, self.L, self.O), dtype=np.float32)
                         if self.has_adam else None)
        self.alpha = (np.zeros((cap, self.O), dtype=np.float32)
                      if self.has_adam else None)

    def _fields(self):
        return (self.feat, self.thr, self.split, self.isnum, self.code,
                self.wleaf, self.raw_leaf, self.alpha)

    def _grow(self, need: int):
        cap = self.cap
        while cap < need:
            cap *= 2
        old = self._fields()
        n = self.n_synced
        self._alloc(cap)
        for new, o in zip(self._fields(), old):
            if new is not None:
                new[:n] = o[:n]

    def _set_trees(self, a: int, feat, thr, is_split, is_numeric, cat_code,
                   lv) -> None:
        """Host arrays of trees [a, a + len(feat)) into the mirror, leaf
        values pre-multiplied by their SGD coefficients (raw leaves and Adam
        step sizes kept beside them on Adam columns)."""
        n = a + len(feat)
        self.feat[a:n] = feat[:, :self.P]
        self.thr[a:n] = thr[:, :self.P]
        self.split[a:n] = is_split[:, :self.P]
        self.isnum[a:n] = is_numeric[:, :self.P]
        self.code[a:n] = cat_code[:, :self.P]
        lv = lv[:, :self.L]
        sgd_specs = [s for s in self.learner.specs if s.algo == "SGD"]
        coeff = _host_sgd_coeff(sgd_specs, a, n, self.O)
        self.wleaf[a:n] = lv * coeff[:, None, :]
        if self.raw_leaf is not None:
            self.raw_leaf[a:n] = lv
            t = np.arange(a, n, dtype=np.float32)
            for s in self.learner.specs:
                if s.algo != "Adam":
                    continue
                lr = _host_lr(s, t)
                al = (lr * np.sqrt(1.0 - s.beta_2 ** (t + 1))
                      / (1.0 - s.beta_1 ** (t + 1)))
                stop = s.stop_idx if s.stop_idx else self.O
                self.alpha[a:n, s.start_idx:stop] = al[:, None]
        self.n_synced = n

    def sync(self) -> int:
        """Copy trees [n_synced, n_trees) and the bias from the learner's
        ensemble: plain slices, one ``.cpu()`` per field.  Returns the number
        of new trees copied.  Recorded as a ``mirror.sync`` span
        (utils/profiling.py) with the trees copied."""
        with profiling.span("mirror.sync") as rec:
            ens = self.learner.ens
            # the host counter and the bias version spare two device reads
            n = getattr(self.learner, "_rl_host_n_trees", None)
            on_card = ens.bias.is_cuda
            if n is None:
                profiling.count_sync("mirror_n_trees", on_card)
                n = int(ens.n_trees)
            a = self.n_synced
            if n > self.cap:
                self._grow(n)
            bv = getattr(self.learner, "_bias_version", None)
            if bv is None or bv != getattr(self, "_seen_bias_version", -1):
                profiling.count_sync("mirror_bias", on_card)
                self.bias = ens.bias.detach().cpu().numpy().astype(
                    np.float32).reshape(self.O)
                self._seen_bias_version = bv
            if n > a:
                profiling.count_sync("mirror_trees", on_card, len(TREE_FIELDS))
                host = [getattr(ens, f)[a:n].cpu().numpy()
                        for f in TREE_FIELDS]
                self._set_trees(a, *host)
            if rec is not None:
                rec.attrs["trees"] = n - a
            return n - a

    def append_tree(self, tree: dict) -> None:
        """Append ONE tree already on the host (numpy arrays: the fields of
        a fitted tree, as the fused A2C update fetches them with its stats)
        without touching the device."""
        t = self.n_synced
        if t + 1 > self.cap:
            self._grow(t + 1)
        self._set_trees(t, *(np.asarray(tree[k])[None] for k in (
            "feat", "thr", "is_split", "is_numeric", "cat_code",
            "leaf_values")))

    # ------------------------------------------------------------------ API
    def _call(self, X, Xc, t0: int, T: int, bias: np.ndarray) -> np.ndarray:
        N, F = X.shape
        out = np.empty((N, self.O), dtype=np.float32)
        Fc = 0 if Xc is None else Xc.shape[1]
        xc_ptr = None
        if Xc is not None:
            Xc = np.ascontiguousarray(Xc, dtype=np.int32)
            xc_ptr = _ptr(Xc)
        i64 = ctypes.c_int64
        # row slices of C-contiguous arrays stay contiguous
        trees = [_ptr(a[t0:]) for a in (self.feat, self.thr, self.split,
                                        self.isnum, self.code)]
        lib = _load_lib()
        if self.has_adam:
            lib.gbrl_mirror_predict_adam(
                _ptr(X), xc_ptr, i64(N), i64(F), i64(Fc), *trees,
                _ptr(self.wleaf), _ptr(self.raw_leaf), _ptr(self.alpha),
                _ptr(self.ab1), _ptr(self.ab2), _ptr(self.aeps),
                _ptr(self.adam_mask), i64(T), i64(self.D), i64(self.O),
                _ptr(bias), _ptr(out))
        else:
            lib.gbrl_mirror_predict(
                _ptr(X), xc_ptr, i64(N), i64(F), i64(Fc), *trees,
                _ptr(self.wleaf[t0:]), i64(T), i64(self.D), i64(self.O),
                _ptr(bias), _ptr(out))
        return out

    def predict_range(self, X: np.ndarray, t0: int, t1: int,
                      Xc: Optional[np.ndarray] = None) -> np.ndarray:
        """Bias-free sum of the SGD tree updates over trees [t0, t1): the
        incremental delta on top of a cached prediction (SGD columns only:
        the Adam recurrence does not split by tree range)."""
        assert not self.has_adam, "predict_range requires SGD-only columns"
        t0 = max(0, min(int(t0), self.n_synced))
        t1 = max(t0, min(int(t1), self.n_synced))
        X = np.ascontiguousarray(X, dtype=np.float32)
        if X.ndim == 1:
            X = X.reshape(1, -1)
        if t1 == t0:
            return np.zeros((X.shape[0], self.O), dtype=np.float32)
        if not self.uses_c_library:
            return self._predict_numpy_range(X, Xc, t0, t1)
        return self._call(X, Xc, t0, t1 - t0,
                          np.zeros(self.O, dtype=np.float32))

    def _predict_numpy_range(self, X, Xc, t0: int, t1: int) -> np.ndarray:
        save = (self.feat, self.thr, self.split, self.isnum, self.code,
                self.wleaf, self.bias, self.n_synced)
        try:
            self.feat, self.thr = self.feat[t0:], self.thr[t0:]
            self.split, self.isnum = self.split[t0:], self.isnum[t0:]
            self.code, self.wleaf = self.code[t0:], self.wleaf[t0:]
            self.bias = np.zeros(self.O, dtype=np.float32)
            self.n_synced = t1 - t0
            return self._predict_numpy(X, Xc)
        finally:
            (self.feat, self.thr, self.split, self.isnum, self.code,
             self.wleaf, self.bias, self.n_synced) = save

    def predict(self, X: np.ndarray, Xc: Optional[np.ndarray] = None
                ) -> np.ndarray:
        """[N, O] predictions for numeric features X (and categorical codes
        Xc), served on the host."""
        X = np.ascontiguousarray(X, dtype=np.float32)
        if X.ndim == 1:
            X = X.reshape(1, -1)
        if not self.uses_c_library:
            return self._predict_numpy(X, Xc)
        return self._call(X, Xc, 0, self.n_synced, self.bias)

    def _predict_numpy(self, X: np.ndarray, Xc: Optional[np.ndarray]
                       ) -> np.ndarray:
        N = X.shape[0]
        T = self.n_synced
        if T == 0:
            return np.broadcast_to(self.bias, (N, self.O)).copy()
        rel = np.zeros((N, T), dtype=np.int64)
        tidx = np.arange(T)
        for d in range(self.D):
            node = (1 << d) - 1 + rel                      # [N, T]
            f = self.feat[tidx[None, :], node]
            s = self.split[tidx[None, :], node].astype(bool)
            isn = self.isnum[tidx[None, :], node].astype(bool)
            thr = self.thr[tidx[None, :], node]
            go = np.take_along_axis(X, np.maximum(f, 0), axis=1) > thr
            if Xc is not None and Xc.shape[1] > 0:
                cc = self.code[tidx[None, :], node]
                goc = np.take_along_axis(Xc, np.maximum(f, 0), axis=1) == cc
                go = np.where(isn, go, goc)
            rel = 2 * rel + (s & go)
        w = self.wleaf[:T]
        out = np.broadcast_to(self.bias, (N, self.O)).copy()
        for tset in range(0, T, 512):
            te = min(tset + 512, T)
            sel = w[tset:te][np.arange(te - tset)[None, :],
                             rel[:, tset:te]]      # [N, C, O]
            out += sel.sum(axis=1)
        if self.has_adam:
            out -= self._adam_delta(rel)
        return out

    def _adam_delta(self, rel: np.ndarray) -> np.ndarray:
        """Accumulated Adam update over each Adam optimizer's columns, [N, O]
        (host replica of ``optimizers.adam_delta``: alpha_t = lr(t)
        sqrt(1 - b2^(t+1)) / (1 - b1^(t+1)), m and v from zero per call),
        vectorized over samples, sequential over trees."""
        N, T = rel.shape
        out = np.zeros((N, self.O), dtype=np.float32)
        if T == 0:
            return out
        g_all = self.raw_leaf[:T][np.arange(T)[None, :], rel]  # [N, T, O]
        t = np.arange(T, dtype=np.float32)
        for spec in self.learner.specs:
            if spec.algo != "Adam":
                continue
            lr = _host_lr(spec, t)
            b1, b2, eps = spec.beta_1, spec.beta_2, spec.eps
            alpha = lr * np.sqrt(1.0 - b2 ** (t + 1)) / (1.0 - b1 ** (t + 1))
            stop = spec.stop_idx or self.O
            cols = slice(spec.start_idx, stop)
            g = g_all[:, :, cols]
            m = np.zeros((N, g.shape[2]), dtype=np.float32)
            v = np.zeros_like(m)
            acc = np.zeros_like(m)
            for k in range(T):
                gk = g[:, k]
                m = b1 * m + (1.0 - b1) * gk
                v = b2 * v + (1.0 - b2) * gk * gk
                acc += alpha[k] * m / (np.sqrt(v) + eps)
            out[:, cols] = acc
        return out
