"""Operations and bytes of fitting one tree and of walking an ensemble."""
from __future__ import annotations

import math

F32 = 4


def tree_bytes(depth: int, outputs: int) -> int:
    """One stored tree: feature (int32), threshold (float32) and split flag
    (1 byte) per inner node, float32 leaf values."""
    return ((1 << depth) - 1) * (F32 + F32 + 1) + (1 << depth) * outputs * F32


def fit(n: int, features: int, bins: int, outputs: int, depth: int,
        oblivious: bool):
    """(operations, bytes) of one tree on n rows: quantile candidates (a
    sort per feature), bucket search, a gradient histogram per level, the
    bucket prefix sums, every candidate's score on every node (children's
    sums, squared norms, the divisions, the square root, the feature
    weight), the argmax, the routing, the leaf means.  Bytes: rows,
    gradients and weights read, the tree written."""
    nodes = (1 << depth) - 1
    cands = features * bins
    ops = features * n * math.ceil(math.log2(max(n, 2)))       # sort
    ops += n * features * math.ceil(math.log2(bins + 1))        # buckets
    ops += depth * n * features * (outputs + 1)                 # histograms
    ops += nodes * features * (bins + 1) * (outputs + 1)        # prefix sums
    ops += nodes * cands * (6 * outputs + 7)                    # scores
    ops += nodes * cands if not oblivious else 2 * nodes * cands  # argmax
    ops += depth * n                                            # routing
    ops += n * (outputs + 1) + (1 << depth) * outputs           # leaf means
    byt = n * (features + outputs + 1) * F32 + tree_bytes(depth, outputs)
    return ops, byt


def walk(n: int, features: int, trees: int, depth: int, outputs: int):
    """(operations, bytes) of an ensemble's predictions for n rows: per row
    and tree ``depth`` compares, then the leaf value times its coefficient
    added to each output.  Bytes: rows and trees read, outputs written."""
    ops = n * trees * (depth + 2 * outputs)
    byt = (n * (features + outputs) * F32
           + trees * tree_bytes(depth, outputs))
    return ops, byt
