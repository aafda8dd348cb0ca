"""Abstract learner interface (counterpart of ``gbrl_tpu/learners/base.py``;
reference: gbrl/learners/base.py:38-392).

A learner owns the device-side ensemble state plus host-side metadata
(optimizer specs, feature mapping, categorical vocabulary).
"""
from __future__ import annotations

from abc import ABC, abstractmethod
from typing import Dict, List, Optional, Union

from ..common.utils import NumericalData, resolve_device
from ..config import TreeConfig, tree_config_from_dicts


class BaseLearner(ABC):
    def __init__(self, input_dim: int, output_dim: int, tree_struct: Dict,
                 optimizers: Union[Dict, List[Dict], None],
                 params: Dict = None, verbose: int = 0, device: str = "cuda"):
        if isinstance(optimizers, dict):
            optimizers = [optimizers]
        if isinstance(optimizers, list):
            optimizers = [o for o in optimizers if o is not None]
        self.input_dim = input_dim
        self.output_dim = output_dim
        self.tree_struct = dict(tree_struct or {})
        self.params = dict(params or {})
        self.optimizers = optimizers
        self.verbose = verbose
        self.torch_device = resolve_device(device)
        self.device = str(device)
        self.cfg: TreeConfig = tree_config_from_dicts(
            input_dim, output_dim, self.tree_struct, self.params,
            verbose=verbose)

    # -- abstract API (mirrors learners/base.py) --
    @abstractmethod
    def reset(self) -> None: ...

    @abstractmethod
    def step(self, inputs: NumericalData, grads: NumericalData, *a, **k) -> None: ...

    @abstractmethod
    def fit(self, *a, **k): ...

    @abstractmethod
    def save(self, filename: str, *a, **k) -> None: ...

    @abstractmethod
    def predict(self, *a, **k): ...

    def export(self, filename: str, modelname: Optional[str] = None) -> None:
        raise NotImplementedError

    @classmethod
    def load(cls, filename: str, device: str = "cuda", *a, **k) -> "BaseLearner":
        raise NotImplementedError

    # -- common conveniences --
    def get_device(self) -> str:
        return self.device

    def set_device(self, device) -> None:
        """Serve and train on ``device`` from now on ("cpu", "cuda" or
        "cuda:i"); asking for CUDA without a card raises."""
        self.torch_device = resolve_device(device)
        self.device = str(device)

    def copy(self):
        return self.__copy__()

    def __copy__(self):
        raise NotImplementedError
