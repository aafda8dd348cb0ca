"""Static configuration for GBT ensembles (copy of ``gbrl_tpu/config.py``).

Mirrors the reference's two config dicts (``tree_struct`` and ``params``,
reference: gbrl/learners/base.py:87-96 and src/cpp/binding.cpp:423-440) as
a single frozen, hashable dataclass.  The port keeps its own copy because
importing anything of ``gbrl_tpu`` imports JAX.
"""
from __future__ import annotations

import dataclasses

# Reference: gbrl/common/config.py:29-31
APPROVED_OPTIMIZERS = ["Adam", "SGD"]
VALID_OPTIMIZER_ARGS = [
    "init_lr", "algo", "stop_lr", "T", "scheduler", "beta_1", "beta_2",
    "eps", "shrinkage", "start_idx", "stop_idx",
]

VALID_GROW_POLICIES = ("greedy", "oblivious")
VALID_SCORE_FUNCS = ("cosine", "l2")
VALID_GENERATORS = ("quantile", "uniform")


@dataclasses.dataclass(frozen=True, eq=True)
class TreeConfig:
    """Hashable static tree/ensemble configuration.

    Defaults follow the reference pybind defaults
    (src/cpp/binding.cpp:423-440): max_depth=4, min_data_in_leaf=0,
    n_bins=256, par_th=10, cv_beta=0.9, batch_size=5000,
    grow_policy="greedy", split_score_func="cosine",
    generator_type="quantile".
    """
    input_dim: int = 1
    output_dim: int = 1
    policy_dim: int = 1
    n_num_features: int = 1
    n_cat_features: int = 0
    max_depth: int = 4
    min_data_in_leaf: int = 0
    n_bins: int = 256
    par_th: int = 10          # kept for API parity
    cv_beta: float = 0.9
    split_score_func: str = "cosine"
    generator_type: str = "quantile"
    use_control_variates: bool = False
    batch_size: int = 5000
    grow_policy: str = "greedy"
    verbose: int = 0

    def __post_init__(self):
        if self.grow_policy not in VALID_GROW_POLICIES:
            raise ValueError(f"grow_policy must be one of {VALID_GROW_POLICIES}")
        if self.split_score_func.lower() not in VALID_SCORE_FUNCS:
            raise ValueError(f"split_score_func must be one of {VALID_SCORE_FUNCS}")
        if self.generator_type.lower() not in VALID_GENERATORS:
            raise ValueError(f"generator_type must be one of {VALID_GENERATORS}")

    @property
    def n_nodes(self) -> int:
        """Internal nodes of a perfect binary tree of depth max_depth."""
        return (1 << self.max_depth) - 1

    @property
    def n_leaves(self) -> int:
        return 1 << self.max_depth

    @property
    def oblivious(self) -> bool:
        return self.grow_policy == "oblivious"

    @property
    def score(self) -> str:
        return self.split_score_func.lower()

    @property
    def generator(self) -> str:
        return self.generator_type.lower()

    def replace(self, **kw) -> "TreeConfig":
        return dataclasses.replace(self, **kw)


def tree_config_from_dicts(input_dim: int, output_dim: int, tree_struct: dict,
                           params: dict, policy_dim: int = 0,
                           verbose: int = 0) -> TreeConfig:
    """Build a TreeConfig from the reference-style dict pair.

    Mirrors gbrl/learners/base.py:87-96 merging of ``tree_struct`` and
    ``params`` into C++ ctor kwargs.
    """
    ts = dict(tree_struct or {})
    pr = dict(params or {})
    return TreeConfig(
        input_dim=input_dim,
        output_dim=output_dim,
        policy_dim=policy_dim or output_dim,
        n_num_features=input_dim,   # refined once feature mapping is known
        n_cat_features=0,
        max_depth=ts.get("max_depth", 4),
        min_data_in_leaf=ts.get("min_data_in_leaf", 0),
        n_bins=ts.get("n_bins", 256),
        par_th=ts.get("par_th", 10),
        batch_size=ts.get("batch_size", 5000),
        grow_policy=ts.get("grow_policy", "greedy"),
        cv_beta=pr.get("cv_beta", 0.9),
        split_score_func=pr.get("split_score_func", "cosine"),
        generator_type=pr.get("generator_type", "quantile"),
        use_control_variates=pr.get("control_variates", False),
        verbose=verbose,
    )
