"""GBTModel: general supervised/RL gradient-boosting model (counterpart of
``gbrl_tpu/models/gbt.py``; reference gbrl/models/gbt.py:39-285)."""
from __future__ import annotations

from typing import Dict, List, Optional, Union

from ..common.utils import (NumericalData, clip_grad_norm, ensure_2d,
                            setup_optimizer, to_numpy, validate_array)
from ..learners.gbt_learner import GBTLearner
from .base import BaseGBT


class GBTModel(BaseGBT):
    """General gradient-boosted trees behind a torch-autograd facade.

    ``__call__`` returns a differentiable leaf tensor on the learner's
    device; after the caller backpropagates a mean-reduced loss, ``step()``
    takes ``params.grad * n_samples`` as per-sample gradients and fits one
    tree (reference: gbt.py:150-178)."""

    def __init__(self, tree_struct: Dict, input_dim: int, output_dim: int,
                 optimizers: Union[Dict, List[Dict]], params: Dict = None,
                 verbose: int = 0, device: str = "cuda"):
        super().__init__()
        if optimizers is not None:
            if isinstance(optimizers, dict):
                optimizers = [optimizers]
            optimizers = [setup_optimizer(opt) for opt in optimizers]
        self.learner = GBTLearner(input_dim=input_dim, output_dim=output_dim,
                                  tree_struct=tree_struct,
                                  optimizers=optimizers,
                                  params=params or {}, verbose=verbose,
                                  device=device)
        self.learner.reset()

    def set_bias(self, bias: NumericalData) -> None:
        self.learner.set_bias(to_numpy(bias).reshape(-1))

    def set_bias_from_targets(self, targets: NumericalData) -> None:
        """bias <- mean(targets) (reference: gbt.py:130-148)."""
        self.learner.set_bias(ensure_2d(to_numpy(targets)).mean(axis=0))

    def step(self, X: Optional[NumericalData] = None,
             grads: Optional[NumericalData] = None,
             max_grad_norm: Optional[float] = None) -> None:
        if X is None:
            assert self.input is not None, (
                "Cannot update trees without input. Make sure model is "
                "called with requires_grad=True")
            X = self.input
        if grads is None:
            assert self.params is not None, \
                "params must be set to compute gradients."
            assert self.params.grad is not None, \
                "params.grad must be set to compute gradients."
            grads = self.params.grad.detach() * len(X)
        grads = clip_grad_norm(grads, max_grad_norm)
        validate_array(to_numpy(grads))
        self.learner.step(X, grads)
        self.grads = grads
        self.input = None

    def fit(self, X: NumericalData, targets: NumericalData, iterations: int,
            shuffle: bool = True, loss_type: str = "MultiRMSE") -> float:
        return self.learner.fit(X, targets, iterations, shuffle, loss_type)

    def distil(self, obs, targets, params: Dict, verbose: int = 0):
        return self.learner.distil(obs, targets, params, verbose)

    @classmethod
    def load_learner(cls, load_name: str, device: str = "cuda") -> "GBTModel":
        instance = cls.__new__(cls)
        BaseGBT.__init__(instance)
        instance.learner = GBTLearner.load(load_name, device)
        return instance

    def __call__(self, X: NumericalData, requires_grad: bool = True,
                 start_idx: int = 0, stop_idx: Optional[int] = None,
                 tensor: bool = True):
        y_pred = self.learner.predict(X, requires_grad, start_idx, stop_idx,
                                      tensor)
        if requires_grad:
            self.grads = None
            self.params = y_pred
            self.input = X
        return y_pred

    def __copy__(self) -> "GBTModel":
        copy_ = GBTModel.__new__(GBTModel)
        BaseGBT.__init__(copy_)
        copy_.learner = self.learner.copy()
        return copy_
