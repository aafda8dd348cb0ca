"""The program side of each algorithm, found by the name a configuration
gives (``"algo"``): how to build its agent, the spans of its traced runs,
the work of each phase, what the check reads from the program, and the
model a serving cell loads."""
from __future__ import annotations

import numpy as np


def replace_arrays(path: str, arrays: dict) -> None:
    """Put ``arrays`` into the port's checkpoint at ``path`` in place of the
    ensemble fields of the same names."""
    file = path if path.endswith(".gbrl_model") else path + ".gbrl_model"
    with np.load(file, allow_pickle=False) as data:
        state = {k: data[k] for k in data.files}
    state.update(arrays)
    with open(file, "wb") as f:
        np.savez_compressed(f, **state)


def heap_arrays(learner, n: int) -> dict:
    """A learner's first n trees as host heap arrays, with its bias."""
    arrs = {f: getattr(learner.ens, f)[:n].cpu().numpy()
            for f in ("feat", "thr", "is_split", "leaf_values")}
    arrs["bias"] = learner.get_bias().astype(np.float64)
    return arrs


def split_arrays(learner, k: int) -> list:
    """A learner's first k trees' splits (feature, threshold, flag)."""
    arrs = {f: getattr(learner.ens, f)[:k].cpu().numpy()
            for f in ("feat", "thr", "is_split")}
    return [{f: a[t] for f, a in arrs.items()} for t in range(k)]
