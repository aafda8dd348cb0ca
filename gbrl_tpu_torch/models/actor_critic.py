"""ActorCritic model (counterpart of ``gbrl_tpu/models/actor_critic.py``;
reference: gbrl/models/actor_critic.py:41-430).

Policy and value in one model; ``shared_tree_struct`` selects one shared
ensemble (policy over columns [0, out-1), value in the last column) or two
separate ensembles.  ``__call__`` / ``predict_policy`` / ``predict_values``
return leaf tensors on the learner's device; after the caller backpropagates
a mean-reduced loss, ``step`` (or, separate mode, ``actor_step`` /
``critic_step``) takes ``grad * n_samples`` as per-sample gradients and fits
one tree.
"""
from __future__ import annotations

import os
from typing import Dict, Optional

import numpy as np

from ..common.utils import (clip_grad_norm, numerical_dtype, setup_optimizer,
                            to_numpy, validate_array)
from ..learners.actor_critic_learner import (SeparateActorCriticLearner,
                                             SharedActorCriticLearner)
from .base import BaseGBT


class ActorCritic(BaseGBT):
    def __init__(self, tree_struct: Dict, input_dim: int, output_dim: int,
                 policy_optimizer: Dict, value_optimizer: Dict,
                 shared_tree_struct: bool = True, params: Dict = None,
                 bias=None, verbose: int = 0, device: str = "cuda"):
        super().__init__()
        policy_optimizer = setup_optimizer(policy_optimizer, prefix="policy_")
        if value_optimizer is not None:
            value_optimizer = setup_optimizer(value_optimizer,
                                              prefix="value_")
        self.shared_tree_struct = True if value_optimizer is None else \
            shared_tree_struct
        if bias is None:
            bias = (np.zeros(output_dim, dtype=numerical_dtype)
                    if self.shared_tree_struct else
                    [np.zeros(output_dim - 1, dtype=numerical_dtype), 0.0])
        if not self.shared_tree_struct and not isinstance(bias, list):
            raise ValueError(
                "When using separate tree structures for actor and critic, "
                "bias must be a list of two elements: [actor_bias, critic_bias]")
        if isinstance(bias, float):
            bias = bias * np.ones(
                output_dim if self.shared_tree_struct else output_dim - 1,
                dtype=numerical_dtype)

        learner_cls = (SharedActorCriticLearner if self.shared_tree_struct
                       else SeparateActorCriticLearner)
        self.learner = learner_cls(
            input_dim=input_dim, output_dim=output_dim,
            tree_struct=tree_struct, policy_optimizer=policy_optimizer,
            value_optimizer=value_optimizer, params=params or {},
            verbose=verbose, device=device)
        self.learner.reset()
        if self.shared_tree_struct:
            self.learner.set_bias(np.asarray(bias, dtype=numerical_dtype))
        else:
            self.learner.set_bias(
                [np.asarray(bias[0], dtype=numerical_dtype).reshape(-1),
                 np.asarray(bias[1], dtype=numerical_dtype).reshape(-1)])
        self.policy_grads = None
        self.value_grads = None

    @classmethod
    def load_learner(cls, load_name: str, device: str = "cuda") -> "ActorCritic":
        """Load a checkpoint written by ``save_learner`` of either package:
        separate when a ``.gbrl_meta`` sidecar exists, else shared."""
        instance = cls.__new__(cls)
        BaseGBT.__init__(instance)
        if os.path.exists(load_name + "_policy.gbrl_meta") or \
                os.path.exists(load_name + ".gbrl_meta"):
            instance.learner = SeparateActorCriticLearner.load(load_name, device)
            instance.shared_tree_struct = False
        else:
            instance.learner = SharedActorCriticLearner.load(load_name, device)
            instance.shared_tree_struct = True
        instance.policy_grads = None
        instance.value_grads = None
        return instance

    def predict_policy(self, observations, requires_grad: bool = True,
                       start_idx: int = 0, stop_idx: Optional[int] = None,
                       tensor: bool = True):
        policy = self.learner.predict_policy(observations, requires_grad,
                                             start_idx, stop_idx, tensor)
        if requires_grad:
            self.policy_grads = None
            self.params = (policy, None)
            self.inputs = observations
        return policy

    def predict_values(self, observations, requires_grad: bool = True,
                       start_idx: int = 0, stop_idx: Optional[int] = None,
                       tensor: bool = True):
        values = self.learner.predict_critic(observations, requires_grad,
                                             start_idx, stop_idx, tensor)
        if requires_grad:
            self.value_grads = None
            self.params = (None, values)
            self.inputs = observations
        return values

    def __call__(self, observations, requires_grad: bool = True,
                 start_idx: int = 0, stop_idx: Optional[int] = None,
                 tensor: bool = True):
        params = self.learner.predict(observations, requires_grad, start_idx,
                                      stop_idx, tensor)
        if requires_grad:
            self.policy_grads = None
            self.value_grads = None
            self.params = tuple(params)
            self.inputs = observations
        return params

    def step(self, observations=None, policy_grads=None, value_grads=None,
             policy_grad_clip: Optional[float] = None,
             value_grad_clip: Optional[float] = None) -> None:
        """One boosting step on policy and value gradients (reference:
        actor_critic.py:230-295)."""
        if observations is None:
            assert self.inputs is not None, (
                "Cannot update trees without input. Make sure model is "
                "called with requires_grad=True")
            observations = self.inputs
        if hasattr(observations, "ndim") and observations.ndim == 1:
            n_samples = 1 if self.learner.input_dim > 1 else len(observations)
        else:
            n_samples = len(observations)
        if policy_grads is None:
            assert self.params is not None and self.params[0] is not None and \
                self.params[0].grad is not None, \
                "params[0].grad must be set to compute gradients."
            policy_grads = self.params[0].grad.detach() * n_samples
        if value_grads is None:
            assert self.params is not None and self.params[1] is not None and \
                self.params[1].grad is not None, \
                "params[1].grad must be set to compute gradients."
            value_grads = self.params[1].grad.detach() * n_samples
        policy_grads = clip_grad_norm(policy_grads, policy_grad_clip)
        value_grads = clip_grad_norm(value_grads, value_grad_clip)
        validate_array(to_numpy(policy_grads))
        validate_array(to_numpy(value_grads))
        if self.shared_tree_struct:
            self.learner.step(observations, (policy_grads, value_grads))
        else:
            self.learner.step(observations, [policy_grads, value_grads])
        self.policy_grads = policy_grads
        self.value_grads = value_grads
        self.inputs = None

    def actor_step(self, observations=None, policy_grads=None,
                   policy_grad_clip: Optional[float] = None) -> None:
        """Separate mode only (reference: actor_critic.py:296-338)."""
        assert not self.shared_tree_struct, \
            "actor_step is only available for separate actor-critic"
        if observations is None:
            observations = self.inputs
        if policy_grads is None:
            policy_grads = self.params[0].grad.detach() * len(observations)
        policy_grads = clip_grad_norm(policy_grads, policy_grad_clip)
        validate_array(to_numpy(policy_grads))
        self.learner.step_actor(observations, policy_grads)
        self.policy_grads = policy_grads

    def critic_step(self, observations=None, value_grads=None,
                    value_grad_clip: Optional[float] = None) -> None:
        """Separate mode only (reference: actor_critic.py:339-380)."""
        assert not self.shared_tree_struct, \
            "critic_step is only available for separate actor-critic"
        if observations is None:
            observations = self.inputs
        if value_grads is None:
            value_grads = self.params[1].grad.detach() * len(observations)
        value_grads = clip_grad_norm(value_grads, value_grad_clip)
        validate_array(to_numpy(value_grads))
        self.learner.step_critic(observations, value_grads)
        self.value_grads = value_grads

    def get_grads(self):
        return self.policy_grads, self.value_grads

    def __copy__(self) -> "ActorCritic":
        instance = ActorCritic.__new__(ActorCritic)
        BaseGBT.__init__(instance)
        instance.learner = self.learner.copy()
        instance.shared_tree_struct = self.shared_tree_struct
        instance.policy_grads = None
        instance.value_grads = None
        return instance
