"""Abstract model facade (counterpart of ``gbrl_tpu/models/base.py``;
reference: gbrl/models/base.py:38-444).

Models hold the last forward pass's differentiable leaf tensors in
``self.params``; ``step()`` harvests their ``.grad`` (scaled by n_samples)
and delegates one boosting iteration to the learner.
"""
from __future__ import annotations

from abc import ABC, abstractmethod
from typing import Optional

from ..common.utils import NumericalData


class BaseGBT(ABC):
    def __init__(self):
        self.learner = None
        self.params = None
        self.grads = None
        self.input = None
        self.inputs = None

    def set_bias(self, *args, **kwargs) -> None:
        self.learner.set_bias(*args, **kwargs)

    def set_feature_weights(self, feature_weights: NumericalData) -> None:
        self.learner.set_feature_weights(feature_weights)

    def get_iteration(self):
        return self.learner.get_iteration()

    def get_total_iterations(self) -> int:
        return self.learner.get_total_iterations()

    def get_schedule_learning_rates(self):
        return self.learner.get_schedule_learning_rates()

    @abstractmethod
    def step(self, *args, **kwargs) -> None: ...

    def fit(self, *args, **kwargs):
        raise NotImplementedError

    def get_num_trees(self, *args, **kwargs):
        return self.learner.get_num_trees(*args, **kwargs)

    def save_learner(self, save_path: str) -> None:
        self.learner.save(save_path)

    def export_learner(self, filename: str, modelname: Optional[str] = None) -> None:
        self.learner.export(filename, modelname)

    @classmethod
    def load_learner(cls, load_name: str, device: str = "cuda") -> "BaseGBT":
        raise NotImplementedError

    def get_params(self):
        return self.params

    def get_grads(self):
        return self.grads

    def set_device(self, device) -> None:
        self.learner.set_device(device)

    def get_device(self):
        return self.learner.get_device()

    def tree_shap(self, tree_idx: int, features: NumericalData, *a, **k):
        return self.learner.tree_shap(tree_idx, features, *a, **k)

    def shap(self, features: NumericalData, *a, **k):
        return self.learner.shap(features, *a, **k)

    def print_tree(self, tree_idx: int, *a, **k) -> None:
        self.learner.print_tree(tree_idx, *a, **k)

    def plot_tree(self, tree_idx: int, filename: str, *a, **k) -> None:
        self.learner.plot_tree(tree_idx, filename, *a, **k)

    @abstractmethod
    def __call__(self, *args, **kwargs): ...

    def copy(self) -> "BaseGBT":
        return self.__copy__()

    @abstractmethod
    def __copy__(self) -> "BaseGBT": ...
