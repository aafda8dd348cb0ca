"""ActorCritic model (counterpart of ``gbrl_tpu/models/actor_critic.py``;
reference: gbrl/models/actor_critic.py:41-430).

Policy and value in one model; ``shared_tree_struct`` selects one shared
ensemble (policy over columns [0, out-1), value in the last column) or two
separate ensembles.  This slice serves predictions: construction,
``load_learner``, ``__call__``, ``predict_policy`` and ``predict_values``;
the boosting steps come with the fit path (ROADMAP.md, slice 2).
"""
from __future__ import annotations

import os
from typing import Dict, Optional

import numpy as np

from ..common.utils import numerical_dtype, setup_optimizer
from ..learners.actor_critic_learner import (SeparateActorCriticLearner,
                                             SharedActorCriticLearner)
from ..learners.base import not_ported
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

    def step(self, *args, **kwargs) -> None:
        raise not_ported("ActorCritic.step", "slice 2 (the fit path)")

    def actor_step(self, *args, **kwargs) -> None:
        raise not_ported("ActorCritic.actor_step", "slice 2 (the fit path)")

    def critic_step(self, *args, **kwargs) -> None:
        raise not_ported("ActorCritic.critic_step", "slice 2 (the fit path)")

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
