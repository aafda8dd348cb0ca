"""Operations and bytes of one serving request: the ensemble walk of its
rows."""
from __future__ import annotations

from . import trees


def request(cfg: dict, rows: int, n_trees: int, outputs: int):
    ts = cfg["tree_struct"]
    return trees.walk(rows, cfg["obs_dim"], n_trees, ts["max_depth"], outputs)
