"""Shared / separate actor-critic learners (counterpart of
``gbrl_tpu/learners/actor_critic_learner.py``; reference
gbrl/learners/actor_critic_learner.py:39-388).

Shared: one ensemble; policy occupies output columns [0, output_dim-1),
value the last column; the two optimizers partition the columns.
Separate: a MultiGBTLearner with output dims [output_dim-1, 1] and names
['Actor', 'Critic'].
"""
from __future__ import annotations

from typing import Dict, Optional

import numpy as np

from ..common.utils import ensure_leaf_output, to_numpy
from .gbt_learner import GBTLearner
from .multi_gbt_learner import MultiGBTLearner


class SharedActorCriticLearner(GBTLearner):
    def __init__(self, input_dim: int, output_dim: int, tree_struct: Dict,
                 policy_optimizer: Dict, value_optimizer: Dict,
                 params: Dict = None, verbose: int = 0, device: str = "cuda",
                 name: str = "SharedActorCritic"):
        super().__init__(input_dim, output_dim, tree_struct,
                         [policy_optimizer, value_optimizer], params,
                         verbose, device, policy_dim=output_dim - 1,
                         name=name)

    def distil(self, obs, policy_targets, value_targets, params: Dict,
               verbose: int = 0):
        pol = to_numpy(policy_targets)
        targets = np.concatenate(
            [pol.reshape(len(pol), -1), to_numpy(value_targets).reshape(-1, 1)],
            axis=1)
        return super().distil(obs, targets, params, verbose)

    def predict(self, inputs, requires_grad: bool = True,
                start_idx: Optional[int] = None,
                stop_idx: Optional[int] = None, tensor: bool = True):
        """-> (policy [N, output_dim-1], values [N]) on the device."""
        preds = self._predict_raw(inputs, start_idx or 0, stop_idx)
        policy = ensure_leaf_output(preds[:, :-1], tensor, requires_grad)
        values = ensure_leaf_output(preds[:, -1], tensor, requires_grad)
        return policy, values

    def predict_policy(self, obs, requires_grad: bool = True,
                       start_idx: Optional[int] = None,
                       stop_idx: Optional[int] = None, tensor: bool = True):
        return self.predict(obs, requires_grad, start_idx, stop_idx, tensor)[0]

    def predict_critic(self, obs, requires_grad: bool = True,
                       start_idx: Optional[int] = None,
                       stop_idx: Optional[int] = None, tensor: bool = True):
        return self.predict(obs, requires_grad, start_idx, stop_idx, tensor)[1]

    @classmethod
    def load(cls, filename: str, device: str = "cuda") -> "SharedActorCriticLearner":
        base = GBTLearner.load(filename, device)
        inst = cls(base.input_dim, base.output_dim, dict(base.tree_struct),
                   dict(base.optimizers[0]), dict(base.optimizers[1]),
                   dict(base.params), base.verbose, device)
        state = dict(base.__dict__)
        state["cfg"] = inst.cfg.replace(
            n_num_features=base.cfg.n_num_features,
            n_cat_features=base.cfg.n_cat_features)
        state["learner_name"] = inst.learner_name
        inst.__dict__.update(state)
        return inst

    def __copy__(self) -> "SharedActorCriticLearner":
        c = SharedActorCriticLearner(
            self.input_dim, self.output_dim, dict(self.tree_struct),
            dict(self.optimizers[0]), dict(self.optimizers[1]),
            dict(self.params), self.verbose, self.device, self.learner_name)
        c.cfg = self.cfg
        c.specs = self.specs
        c.ens = self.ens
        c.feature_weights = self.feature_weights.copy()
        c.num_mask = self.num_mask.copy()
        c._mapping_set = self._mapping_set
        c.vocab = self.vocab
        c.total_iterations = self.total_iterations
        return c


class SeparateActorCriticLearner(MultiGBTLearner):
    def __init__(self, input_dim: int, output_dim: int, tree_struct: Dict,
                 policy_optimizer: Dict, value_optimizer: Dict,
                 params: Dict = None, verbose: int = 0, device: str = "cuda"):
        # the two models own their full output ranges
        policy_optimizer = dict(policy_optimizer)
        value_optimizer = dict(value_optimizer)
        policy_optimizer["start_idx"], policy_optimizer["stop_idx"] = \
            0, output_dim - 1
        value_optimizer["start_idx"], value_optimizer["stop_idx"] = 0, 1
        super().__init__(input_dim, [output_dim - 1, 1], tree_struct,
                         [policy_optimizer, value_optimizer], params,
                         n_learners=2, verbose=verbose, device=device,
                         custom_names=["Actor", "Critic"])
        self.output_dim = output_dim

    def step_actor(self, inputs, grads) -> None:
        self.step(inputs, grads, model_idx=0)

    def step_critic(self, inputs, grads) -> None:
        self.step(inputs, grads, model_idx=1)

    def predict_policy(self, obs, requires_grad: bool = True,
                       start_idx: int = 0, stop_idx: Optional[int] = None,
                       tensor: bool = True):
        return self.predict(obs, requires_grad, start_idx, stop_idx, tensor,
                            model_idx=0)

    def predict_critic(self, obs, requires_grad: bool = True,
                       start_idx: int = 0, stop_idx: Optional[int] = None,
                       tensor: bool = True):
        return self.predict(obs, requires_grad, start_idx, stop_idx, tensor,
                            model_idx=1)
