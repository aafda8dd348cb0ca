"""Model introspection: textual/graphviz tree dumps and ensemble export
(counterpart of ``gbrl_tpu/utils/introspection.py``; reference:
gbrl.cpp:1254-1544 print_tree/plot_tree, binding.cpp:309-390 get_metadata,
get_ensemble_data).  The text is the JAX package's, byte for byte; a tree's
fields are copied to the host once per call."""
from __future__ import annotations

import shutil
import subprocess
from typing import Dict

import numpy as np

from ..config import TreeConfig
from ..ensemble import FIELDS, Ensemble

_TREE_FIELDS = ("feat", "thr", "is_split", "is_numeric", "cat_code",
                "leaf_values", "counts")


def _tree_arrays(ens: Ensemble, tree_idx: int):
    return tuple(getattr(ens, f)[tree_idx].cpu().numpy()
                 for f in _TREE_FIELDS)


def format_tree(cfg: TreeConfig, ens: Ensemble, tree_idx: int) -> str:
    """Human-readable dump of one tree (analog of GBRL::print_tree)."""
    n_trees = int(ens.n_trees)
    if tree_idx < 0 or tree_idx >= n_trees:
        return f"tree_idx {tree_idx} out of range [0, {n_trees})"
    feat, thr, is_split, is_num, code, lv, counts = _tree_arrays(ens, tree_idx)
    D = cfg.max_depth
    L = 1 << D
    lines = [f"Tree {tree_idx} (depth {int(ens.depths[tree_idx])}, "
             f"output_dim {cfg.output_dim})"]

    def rec(p: int, depth: int, indent: str):
        if depth == D or not is_split[p]:
            # pass-through/leaf: value lives at the left-most descendant leaf
            q = p
            for _ in range(depth, D):
                q = 2 * q + 1
            leaf = q - (L - 1)
            vals = np.array2string(lv[leaf], precision=5, separator=", ")
            n = counts[p] if p < 2 * L - 1 else 0.0
            lines.append(f"{indent}leaf n={n:.0f} value={vals}")
            return
        cond = (f"x[{feat[p]}] > {thr[p]:.6g}" if is_num[p]
                else f"cat[{feat[p]}] == {code[p]}")
        lines.append(f"{indent}node {p}: if {cond} (n={counts[p]:.0f})")
        rec(2 * p + 1, depth + 1, indent + "  ")
        rec(2 * p + 2, depth + 1, indent + "  ")

    rec(0, 0, "  ")
    return "\n".join(lines)


def plot_tree(cfg: TreeConfig, ens: Ensemble, tree_idx: int,
              filename: str) -> None:
    """Graphviz PNG render when the `dot` binary exists, else a .dot file
    (reference compiles against libgraphviz; we shell out, gbrl.cpp:1409-1544)."""
    feat, thr, is_split, is_num, code, lv, counts = _tree_arrays(ens, tree_idx)
    D = cfg.max_depth
    L = 1 << D
    lines = ["digraph tree {", '  node [shape=box, fontsize=10];']

    def rec(p: int, depth: int):
        if depth == D or not is_split[p]:
            q = p
            for _ in range(depth, D):
                q = 2 * q + 1
            leaf = q - (L - 1)
            vals = np.array2string(lv[leaf], precision=4, separator=",")
            lines.append(f'  n{p} [label="leaf\\n{vals}", style=filled, '
                         'fillcolor=lightblue];')
            return
        cond = (f"x[{feat[p]}] > {thr[p]:.4g}" if is_num[p]
                else f"cat[{feat[p]}] == {code[p]}")
        lines.append(f'  n{p} [label="{cond}\\nn={counts[p]:.0f}"];')
        for child, lbl in ((2 * p + 1, "no"), (2 * p + 2, "yes")):
            lines.append(f'  n{p} -> n{child} [label="{lbl}"];')
            rec(child, depth + 1)

    rec(0, 0)
    lines.append("}")
    dot = "\n".join(lines)
    if not filename.endswith(".png"):
        filename = filename + ".png"
    dot_bin = shutil.which("dot")
    if dot_bin:
        proc = subprocess.run([dot_bin, "-Tpng", "-o", filename],
                              input=dot.encode(), capture_output=True)
        if proc.returncode != 0:
            raise RuntimeError(f"graphviz failed: {proc.stderr.decode()}")
    else:
        with open(filename.replace(".png", ".dot"), "w") as f:
            f.write(dot)


def get_ensemble_data(cfg: TreeConfig, ens: Ensemble) -> Dict[str, np.ndarray]:
    """The fitted trees' SoA arrays as numpy (analog of binding.cpp:330-390)."""
    n = int(ens.n_trees)
    data = {f: getattr(ens, f)[:n].cpu().numpy()
            for f in FIELDS if f not in ("bias", "n_trees")}
    data.update(bias=ens.bias.cpu().numpy(), n_trees=n)
    return data


def get_ensemble_metadata(cfg: TreeConfig, ens: Ensemble) -> Dict:
    """Analog of binding.cpp get_metadata (309-328)."""
    n = int(ens.n_trees)
    return dict(
        input_dim=cfg.input_dim, output_dim=cfg.output_dim,
        policy_dim=cfg.policy_dim, max_depth=cfg.max_depth,
        min_data_in_leaf=cfg.min_data_in_leaf, n_bins=cfg.n_bins,
        par_th=cfg.par_th, cv_beta=cfg.cv_beta,
        split_score_func=cfg.split_score_func,
        generator_type=cfg.generator_type,
        use_control_variates=cfg.use_control_variates,
        batch_size=cfg.batch_size, grow_policy=cfg.grow_policy,
        n_trees=n, n_leaves=n * cfg.n_leaves, iteration=n)
