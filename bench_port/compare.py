"""The arithmetic of the comparisons that decide ``correct``.

A training cell compares, per leaf (a block of output columns with one
optimizer: policy and value, or critic and actor), the norm the program
gives and the norm the reference gives, never the norm of their
difference: the gap is |program - reference| over the larger of the
reference's norm of that leaf and its median leaf's.  A leaf whose
gradient in the reference is under a thousandth of the median leaf's is
left out: rounding alone moves it."""
from __future__ import annotations

import numpy as np

LEAF_FLOOR = 1e-3


def kept_leaves(ref_grad_norms: dict) -> list:
    med = float(np.median(list(ref_grad_norms.values())))
    return [k for k, v in ref_grad_norms.items() if v >= LEAF_FLOOR * med]


def norm_gap(prog: dict, ref: dict, leaves: list) -> float:
    """The worst leaf's gap of norms."""
    med = float(np.median([ref[k] for k in ref]))
    return float(max(abs(prog[k] - ref[k]) / max(ref[k], med, 1e-300)
                     for k in leaves))


def loss_gap(prog, ref) -> float:
    """The worst step's relative gap of losses."""
    prog = np.asarray(prog, np.float64)
    ref = np.asarray(ref, np.float64)
    return float(np.max(np.abs(prog - ref) / np.maximum(np.abs(ref), 1e-300)))


def forward_gap(prog, ref) -> float:
    """The widest gap of one output over the root mean square of the
    reference's outputs."""
    prog = np.asarray(prog, np.float64)
    ref = np.asarray(ref, np.float64)
    scale = max(float(np.sqrt(np.mean(ref * ref))), 1e-6)
    return float(np.max(np.abs(prog - ref))) / scale


def norms(delta: np.ndarray, columns: dict, scale: dict = None) -> dict:
    """The L2 norm of each leaf's columns of ``delta`` [n, O] (divided by
    the leaf's ``scale``)."""
    out = {}
    for k, cols in columns.items():
        v = float(np.linalg.norm(np.asarray(delta)[:, cols]))
        out[k] = v / scale[k] if scale else v
    return out
