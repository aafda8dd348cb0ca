"""Critic models with ensemble-prefix target networks (counterpart of
``gbrl_tpu/models/critic.py``; reference gbrl/models/critic.py:42-420).

The target network is the ensemble truncated to ``target_prefix`` trees,
snapped to n_trees every ``target_update_interval`` boosting steps
(critic.py:165-168): prediction with ``stop_idx=target_prefix``.
"""
from __future__ import annotations

from typing import Dict, Optional

from ..common.utils import (clip_grad_norm, ensure_leaf_output,
                            setup_optimizer, to_numpy, validate_array)
from ..learners.gbt_learner import GBTLearner
from .actor import _bias, _n_samples
from .base import BaseGBT


class ContinuousCritic(BaseGBT):
    """Outputs parameters (weights, bias) for linear/quadratic/tanh
    Q(theta(s), a) forms (reference: critic.py:42-255)."""

    def __init__(self, tree_struct: Dict, input_dim: int, output_dim: int,
                 weights_optimizer: Dict, bias_optimizer: Optional[Dict] = None,
                 params: Dict = None, target_update_interval: int = 100,
                 bias=None, verbose: int = 0, device: str = "cuda"):
        self.weights_optimizer = setup_optimizer(weights_optimizer,
                                                 prefix="weights_")
        self.bias_optimizer = (setup_optimizer(bias_optimizer, prefix="bias_")
                               if bias_optimizer is not None else None)
        super().__init__()
        self.target_update_interval = target_update_interval
        self.learner = GBTLearner(
            input_dim=input_dim, output_dim=output_dim,
            tree_struct=tree_struct,
            optimizers=[self.weights_optimizer, self.bias_optimizer],
            params=params or {}, verbose=verbose, device=device)
        self.learner.reset()
        self.learner.set_bias(_bias(bias, output_dim))
        self.target_prefix = 0

    def step(self, observations=None, weight_grads=None, bias_grads=None,
             q_grad_clip: Optional[float] = None) -> None:
        if observations is None:
            assert self.input is not None, "Cannot update trees without input."
            observations = self.input
        n = _n_samples(observations, self.learner.input_dim)
        if weight_grads is None:
            assert self.params is not None and \
                self.params[0].grad is not None
            weight_grads = self.params[0].grad.detach() * n
        if bias_grads is None:
            assert self.bias_optimizer is not None, \
                "bias_optimizer must be set to compute bias gradients."
            assert self.params is not None and \
                self.params[1].grad is not None
            bias_grads = self.params[1].grad.detach() * n
        weight_grads = clip_grad_norm(weight_grads, q_grad_clip)
        bias_grads = clip_grad_norm(bias_grads, q_grad_clip)
        validate_array(to_numpy(weight_grads))
        validate_array(to_numpy(bias_grads))
        self.learner.step(observations, (weight_grads, bias_grads))
        self.grads = (weight_grads, bias_grads)
        self.input = None
        n_trees = self.learner.get_num_trees()
        if n_trees % self.target_update_interval == 0:
            self.target_prefix = n_trees

    def _split(self, theta, tensor: bool, requires_grad: bool, squeeze: bool):
        w = theta[:, self.weights_optimizer["start_idx"]:
                  self.weights_optimizer["stop_idx"]]
        b = theta[:, self.bias_optimizer["start_idx"]:
                  self.bias_optimizer["stop_idx"]]
        if squeeze:
            w, b = w.squeeze(), b.squeeze()
        return (ensure_leaf_output(w, tensor, requires_grad),
                ensure_leaf_output(b, tensor, requires_grad))

    def predict_target(self, observations, tensor: bool = True):
        assert self.bias_optimizer is not None, \
            "bias_optimizer must be set to use target prediction."
        theta = self.learner._predict_raw(observations,
                                          stop_idx=self.target_prefix)
        return self._split(theta, tensor, False, squeeze=False)

    def __call__(self, observations, requires_grad: bool = True,
                 target: bool = False, start_idx: Optional[int] = None,
                 stop_idx: Optional[int] = None, tensor: bool = True):
        if target:
            return self.predict_target(observations, tensor)
        assert self.bias_optimizer is not None, \
            "bias_optimizer must be set to use call()."
        theta = self.learner._predict_raw(observations, start_idx or 0,
                                          stop_idx)
        w, b = self._split(theta, tensor, requires_grad, squeeze=True)
        if requires_grad:
            self.grads = None
            self.params = (w, b)
            self.input = observations
        return w, b

    def __copy__(self) -> "ContinuousCritic":
        copy_ = ContinuousCritic.__new__(ContinuousCritic)
        BaseGBT.__init__(copy_)
        copy_.__dict__.update(self.__dict__)
        copy_.learner = self.learner.copy()
        return copy_


class DiscreteCritic(BaseGBT):
    """Q-values per discrete action (reference: critic.py:258-420)."""

    def __init__(self, tree_struct: Dict, input_dim: int, output_dim: int,
                 critic_optimizer: Dict, params: Dict = None,
                 target_update_interval: int = 100, bias=None,
                 verbose: int = 0, device: str = "cuda"):
        critic_optimizer = setup_optimizer(critic_optimizer, prefix="critic_")
        super().__init__()
        self.critic_optimizer = critic_optimizer
        self.target_update_interval = target_update_interval
        self.learner = GBTLearner(input_dim=input_dim, output_dim=output_dim,
                                  tree_struct=tree_struct,
                                  optimizers=critic_optimizer,
                                  params=params or {}, verbose=verbose,
                                  device=device)
        self.learner.reset()
        self.learner.set_bias(_bias(bias, output_dim))
        self.target_prefix = 0

    def step(self, observations=None, q_grads=None,
             max_q_grad_norm: Optional[float] = None) -> None:
        if observations is None:
            assert self.input is not None, "Cannot update trees without input."
            observations = self.input
        n = _n_samples(observations, self.learner.input_dim)
        if q_grads is None:
            assert self.params is not None and self.params.grad is not None
            q_grads = self.params.grad.detach() * n
        q_grads = clip_grad_norm(q_grads, max_q_grad_norm)
        self.learner.step(observations, q_grads)
        self.grads = q_grads
        self.input = None
        n_trees = self.learner.get_num_trees()
        if n_trees % self.target_update_interval == 0:
            self.target_prefix = n_trees

    def __call__(self, observations, requires_grad: bool = True,
                 start_idx: int = 0, stop_idx: Optional[int] = None,
                 tensor: bool = True):
        q_values = self.learner.predict(observations, requires_grad,
                                        start_idx, stop_idx, tensor)
        if requires_grad:
            self.grads = None
            self.params = q_values
            self.input = observations
        return q_values

    def predict_target(self, observations, tensor: bool = True):
        """The ensemble prefix of ``target_prefix`` trees."""
        return self.learner.predict(observations, requires_grad=False,
                                    stop_idx=self.target_prefix,
                                    tensor=tensor)

    def __copy__(self) -> "DiscreteCritic":
        copy_ = DiscreteCritic.__new__(DiscreteCritic)
        BaseGBT.__init__(copy_)
        copy_.__dict__.update(self.__dict__)
        copy_.learner = self.learner.copy()
        return copy_
