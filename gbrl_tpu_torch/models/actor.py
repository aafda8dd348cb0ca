"""Actor models (counterpart of ``gbrl_tpu/models/actor.py``; reference
gbrl/models/actor.py:42-391)."""
from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from ..common.utils import (clip_grad_norm, ensure_leaf_output,
                            numerical_dtype, setup_optimizer, to_numpy,
                            validate_array)
from ..learners.gbt_learner import GBTLearner
from .base import BaseGBT


def _n_samples(observations, input_dim: int) -> int:
    if getattr(observations, "ndim", None) == 1:
        return 1 if input_dim > 1 else len(observations)
    return len(observations)


def _bias(bias, output_dim: int) -> np.ndarray:
    if bias is None:
        return np.zeros(output_dim, dtype=numerical_dtype)
    if isinstance(bias, float):
        return bias * np.ones(output_dim, dtype=numerical_dtype)
    return np.array(bias, dtype=numerical_dtype)


class ParametricActor(BaseGBT):
    """One parameter per action dimension (discrete policies)
    (reference: actor.py:42-190)."""

    def __init__(self, tree_struct: Dict, input_dim: int, output_dim: int,
                 policy_optimizer: Dict, params: Dict = None,
                 bias=None, verbose: int = 0, device: str = "cuda"):
        policy_optimizer = setup_optimizer(policy_optimizer, prefix="policy_")
        super().__init__()
        self.learner = GBTLearner(input_dim=input_dim, output_dim=output_dim,
                                  tree_struct=tree_struct,
                                  optimizers=policy_optimizer,
                                  params=params or {}, verbose=verbose,
                                  device=device)
        self.learner.reset()
        self.learner.set_bias(_bias(bias, output_dim))

    def step(self, observations=None, policy_grads=None,
             policy_grad_clip: Optional[float] = None) -> None:
        if observations is None:
            assert self.input is not None, "Cannot update trees without input."
            observations = self.input
        n = _n_samples(observations, self.learner.input_dim)
        if policy_grads is None:
            assert self.params is not None and self.params.grad is not None, \
                "params.grad must be set to compute gradients."
            policy_grads = self.params.grad.detach() * n
        policy_grads = clip_grad_norm(policy_grads, policy_grad_clip)
        validate_array(to_numpy(policy_grads))
        self.learner.step(observations, policy_grads)
        self.grads = policy_grads
        self.input = None

    def __call__(self, observations, requires_grad: bool = True,
                 start_idx: Optional[int] = None,
                 stop_idx: Optional[int] = None, tensor: bool = True):
        params = self.learner.predict(observations, requires_grad,
                                      start_idx or 0, stop_idx, tensor)
        if requires_grad:
            self.grads = None
            self.params = params
            self.input = observations
        return params

    def __copy__(self) -> "ParametricActor":
        copy_ = ParametricActor.__new__(ParametricActor)
        BaseGBT.__init__(copy_)
        copy_.learner = self.learner.copy()
        return copy_


class GaussianActor(BaseGBT):
    """Outputs (mu, log_std) of a Gaussian policy (reference:
    actor.py:193-391).  With a std optimizer the output columns split in
    half, mu then log_std, and the bias tail is log_std_init; without one,
    log_std is the constant log_std_init."""

    def __init__(self, tree_struct: Dict, input_dim: int, output_dim: int,
                 mu_optimizer: Dict, std_optimizer: Optional[Dict] = None,
                 log_std_init: float = -2, params: Dict = None,
                 bias=None, verbose: int = 0, device: str = "cuda"):
        super().__init__()
        mu_optimizer = setup_optimizer(mu_optimizer, prefix="mu_")
        bias = _bias(bias, output_dim)
        policy_dim = output_dim
        if std_optimizer is not None:
            std_optimizer = setup_optimizer(std_optimizer, prefix="std_")
            policy_dim = output_dim // 2
            bias[policy_dim:] = log_std_init
        self.log_std_init = log_std_init
        self.fixed_std = std_optimizer is None
        self.policy_dim = policy_dim
        self.learner = GBTLearner(input_dim=input_dim, output_dim=output_dim,
                                  tree_struct=tree_struct,
                                  optimizers=[mu_optimizer, std_optimizer],
                                  params=params or {}, verbose=verbose,
                                  device=device)
        self.learner.reset()
        self.learner.set_bias(bias)

    def step(self, observations=None, mu_grads=None, log_std_grads=None,
             mu_grad_clip: Optional[float] = None,
             log_std_grad_clip: Optional[float] = None) -> None:
        if observations is None:
            assert self.input is not None, "Cannot update trees without input."
            observations = self.input
        n = _n_samples(observations, self.learner.input_dim)
        if mu_grads is None:
            assert self.params is not None and \
                self.params[0].grad is not None, \
                "params[0].grad must be set to compute gradients."
            mu_grads = self.params[0].grad.detach() * n
        mu_grads = clip_grad_norm(mu_grads, mu_grad_clip)
        validate_array(to_numpy(mu_grads))
        if self.fixed_std:
            self.learner.step(observations, mu_grads)
            self.grads = mu_grads
        else:
            if log_std_grads is None:
                assert self.params is not None and \
                    self.params[1].grad is not None, \
                    "params[1].grad must be set to compute gradients."
                log_std_grads = self.params[1].grad.detach() * n
            log_std_grads = clip_grad_norm(log_std_grads, log_std_grad_clip)
            validate_array(to_numpy(log_std_grads))
            self.learner.step(observations, (mu_grads, log_std_grads))
            self.grads = (mu_grads, log_std_grads)
        self.input = None

    def __call__(self, observations, requires_grad: bool = True,
                 start_idx: Optional[int] = None,
                 stop_idx: Optional[int] = None, tensor: bool = True):
        theta = self.learner._predict_raw(observations, start_idx or 0,
                                          stop_idx)
        if self.fixed_std:
            mean_actions = ensure_leaf_output(theta, tensor, requires_grad)
            log_std = ensure_leaf_output(
                torch.full_like(theta, self.log_std_init), tensor, False)
        else:
            mean_actions = ensure_leaf_output(theta[:, :self.policy_dim],
                                              tensor, requires_grad)
            log_std = ensure_leaf_output(theta[:, self.policy_dim:], tensor,
                                         requires_grad)
        if requires_grad:
            self.grads = None
            self.params = (mean_actions, log_std)
            self.input = observations
        return mean_actions, log_std

    def __copy__(self) -> "GaussianActor":
        copy_ = GaussianActor.__new__(GaussianActor)
        BaseGBT.__init__(copy_)
        copy_.learner = self.learner.copy()
        copy_.log_std_init = self.log_std_init
        copy_.fixed_std = self.fixed_std
        copy_.policy_dim = self.policy_dim
        return copy_
