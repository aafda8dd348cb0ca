"""Native serving runtime: compile an exported ensemble into a host shared
library for dependency-free, microsecond-latency inference (counterpart of
``gbrl_tpu/utils/c_runtime.py``).

This is the deployment analog of the reference's C-header export
(types.cpp:409+) taken one step further: the header is compiled on the spot
(g++ -O3) into a ``.so`` with a batched entry point and served through
ctypes — no PyTorch, no Python per-sample overhead.  It serves actors on
CPU hosts while the learner trains on the GPU, so it stays on the host by
design.
"""
from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import tempfile

import numpy as np

_WRAPPER = """
#include "{header}"

#ifdef __cplusplus
extern "C" {{
#endif
void {name}_predict_batch(float *results, const float *features, int n) {{
    int i;
    for (i = 0; i < n; ++i) {{
        {name}_predict(results + (long)i * {name_up}_N_OUTPUTS,
                       features + (long)i * {name_up}_N_FEATURES);
    }}
}}
#ifdef __cplusplus
}}
#endif
"""


class CompiledModel:
    """Compile a trained learner's ensemble to native code and predict.

    >>> rt = CompiledModel.from_learner(model.learner)
    >>> preds = rt(X)          # numpy [N, O]
    """

    def __init__(self, so_path: str, n_features: int, n_outputs: int,
                 name: str = "gbrl_model", workdir=None):
        self._workdir = workdir            # keeps the tempdir alive
        self.n_features = n_features
        self.n_outputs = n_outputs
        self._lib = ctypes.CDLL(so_path)
        self._fn = getattr(self._lib, f"{name}_predict_batch")
        self._fn.restype = None
        self._fn.argtypes = [ctypes.POINTER(ctypes.c_float),
                             ctypes.POINTER(ctypes.c_float),
                             ctypes.c_int]

    @classmethod
    def from_learner(cls, learner, name: str = "gbrl_model") -> "CompiledModel":
        cxx = shutil.which("g++") or shutil.which("cc")
        if cxx is None:
            raise RuntimeError("no C compiler available")
        if getattr(learner.cfg, "n_cat_features", 0) > 0:
            # the exported header's predict for categorical models takes an
            # extra cat_features argument the batch wrapper doesn't pass
            raise ValueError(
                "CompiledModel.from_learner supports numeric-feature models "
                "only (this learner has categorical features; use "
                "export_ensemble_header + the 3-argument predict directly)")
        wd = tempfile.TemporaryDirectory(prefix="gbrl_native_")
        header = os.path.join(wd.name, f"{name}.h")
        learner.export(header, name, export_format="float")
        src = os.path.join(wd.name, "wrapper.c")
        with open(src, "w") as f:
            f.write(_WRAPPER.format(header=header, name=name,
                                    name_up=name.upper()))
        so = os.path.join(wd.name, f"{name}.so")
        proc = subprocess.run([cxx, "-O3", "-shared", "-fPIC", src, "-o", so],
                              capture_output=True)
        if proc.returncode != 0:
            raise RuntimeError(
                f"native compile failed (exit {proc.returncode}):\n"
                f"{proc.stderr.decode(errors='replace')[-2000:]}")
        return cls(so, learner.cfg.n_num_features, learner.output_dim,
                   name, workdir=wd)

    def __call__(self, X: np.ndarray) -> np.ndarray:
        X = np.ascontiguousarray(X, dtype=np.float32)
        if X.ndim == 1:
            X = X[None, :]
        n = X.shape[0]
        assert X.shape[1] == self.n_features
        out = np.empty((n, self.n_outputs), dtype=np.float32)
        self._fn(out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
                 X.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
                 ctypes.c_int(n))
        return out
