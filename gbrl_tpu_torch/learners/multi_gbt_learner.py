"""MultiGBTLearner: N independent ensembles sharing one input (counterpart
of ``gbrl_tpu/learners/multi_gbt_learner.py``; reference
gbrl/learners/multi_gbt_learner.py:44-873).

Fitting (``step``, ``fit``) fans out to the per-model ``GBTLearner``s,
addressed by ``model_idx`` or broadcast over all models.  A checkpoint is one ``.gbrl_model`` per model plus a ``.gbrl_meta`` JSON
sidecar, as in the JAX package.
"""
from __future__ import annotations

import json
from typing import Dict, List, Optional, Union

import numpy as np

from ..common.utils import NumericalData
from .base import BaseLearner
from .gbt_learner import GBTLearner


class MultiGBTLearner(BaseLearner):
    def __init__(self, input_dim: int,
                 output_dim: Union[int, List[int]],
                 tree_struct: Dict,
                 optimizers: Union[Dict, List[Dict]],
                 params: Dict = None,
                 n_learners: int = 2,
                 verbose: int = 0, device: str = "cuda",
                 custom_names: Optional[List[str]] = None):
        out_dims = (output_dim if isinstance(output_dim, list)
                    else [output_dim] * n_learners)
        opts = (optimizers if isinstance(optimizers, list)
                else [optimizers] * n_learners)
        assert len(out_dims) == n_learners and len(opts) == n_learners
        self.n_learners = n_learners
        self.custom_names = custom_names or [
            f"model_{i}" for i in range(n_learners)]
        super().__init__(input_dim, out_dims[0], tree_struct,
                         None, params, verbose, device)
        self.learners = [
            GBTLearner(input_dim, out_dims[i], tree_struct,
                       opts[i] if isinstance(opts[i], list) else [opts[i]],
                       params, verbose, device, name=self.custom_names[i])
            for i in range(n_learners)]
        self.optimizers = opts

    def _sel(self, model_idx: Optional[int]):
        if model_idx is None:
            return list(range(self.n_learners))
        assert 0 <= model_idx < self.n_learners, \
            f"model_idx {model_idx} out of range"
        return [model_idx]

    def reset(self) -> None:
        for lr in self.learners:
            lr.reset()

    def step(self, inputs: NumericalData, grads,
             model_idx: Optional[int] = None) -> None:
        if model_idx is not None:
            self.learners[model_idx].step(inputs, grads)
            return
        assert isinstance(grads, (list, tuple)) and \
            len(grads) == self.n_learners, \
            "broadcast step requires one gradient array per learner"
        for lr, gi in zip(self.learners, grads):
            lr.step(inputs, gi)

    def fit(self, features, targets, iterations: int, shuffle: bool = True,
            loss_type: str = "MultiRMSE",
            model_idx: Optional[int] = None) -> Union[float, List[float]]:
        sel = self._sel(model_idx)
        losses = []
        for i in sel:
            t = targets[i] if isinstance(targets, (list, tuple)) else targets
            losses.append(self.learners[i].fit(features, t, iterations,
                                               shuffle, loss_type))
        return losses[0] if len(sel) == 1 else losses

    # ------------------------------------------------------------- inference
    def predict(self, inputs, requires_grad: bool = True,
                start_idx: int = 0, stop_idx: Optional[int] = None,
                tensor: bool = True, model_idx: Optional[int] = None):
        sel = self._sel(model_idx)
        preds = [self.learners[i].predict(inputs, requires_grad, start_idx,
                                          stop_idx, tensor) for i in sel]
        return preds[0] if len(preds) == 1 else tuple(preds)

    # ---------------------------------------------------------- introspection
    def _fan(self, fname, model_idx: Optional[int] = None, *a, **k):
        sel = self._sel(model_idx)
        out = [getattr(self.learners[i], fname)(*a, **k) for i in sel]
        return out[0] if len(out) == 1 else tuple(out)

    def get_iteration(self, model_idx: Optional[int] = None):
        return self._fan("get_iteration", model_idx)

    def get_num_trees(self, model_idx: Optional[int] = None):
        return self._fan("get_num_trees", model_idx)

    def get_total_iterations(self) -> int:
        return sum(lr.get_total_iterations() for lr in self.learners)

    def get_schedule_learning_rates(self, model_idx: Optional[int] = None):
        return self._fan("get_schedule_learning_rates", model_idx)

    def get_optimizers(self, model_idx: Optional[int] = None):
        out = []
        for i in self._sel(model_idx):
            out.extend(self.learners[i].get_optimizers())
        return out

    def set_bias(self, bias, model_idx: Optional[int] = None) -> None:
        sel = self._sel(model_idx)
        if len(sel) > 1:
            assert isinstance(bias, (list, tuple)) and len(bias) == len(sel), \
                "broadcast set_bias requires one bias per learner"
            for i, b in zip(sel, bias):
                self.learners[i].set_bias(
                    np.asarray(b, dtype=np.float32).reshape(-1))
        else:
            self.learners[sel[0]].set_bias(bias)

    def get_bias(self, model_idx: Optional[int] = None):
        return self._fan("get_bias", model_idx)

    def set_feature_weights(self, feature_weights,
                            model_idx: Optional[int] = None) -> None:
        for i in self._sel(model_idx):
            self.learners[i].set_feature_weights(feature_weights)

    def get_feature_weights(self, model_idx: Optional[int] = None):
        return self._fan("get_feature_weights", model_idx)

    def get_device(self, model_idx: Optional[int] = None):
        return self._fan("get_device", model_idx)

    def set_device(self, device, model_idx: Optional[int] = None) -> None:
        super().set_device(device)
        for i in self._sel(model_idx):
            self.learners[i].set_device(device)

    def print_tree(self, tree_idx: int,
                   model_idx: Optional[int] = None) -> None:
        self._fan("print_tree", model_idx, tree_idx)

    def plot_tree(self, tree_idx: int, filename: str,
                  model_idx: Optional[int] = None) -> None:
        for i in self._sel(model_idx):
            self.learners[i].plot_tree(tree_idx,
                                       f"{filename}_{self.custom_names[i]}")

    def print_ensemble_metadata(self) -> None:
        for lr in self.learners:
            lr.print_ensemble_metadata()

    def tree_shap(self, tree_idx: int, features,
                  model_idx: Optional[int] = None):
        return self._fan("tree_shap", model_idx, tree_idx, features)

    def shap(self, features, model_idx: Optional[int] = None):
        return self._fan("shap", model_idx, features)

    def distil(self, obs, targets, params: Dict, verbose: int = 0,
               model_idx: Optional[int] = None):
        out = []
        for i in self._sel(model_idx):
            t = targets[i] if isinstance(targets, (list, tuple)) else targets
            out.append(self.learners[i].distil(obs, t, params, verbose))
        return out[0] if len(out) == 1 else tuple(out)

    # ------------------------------------------------------------- checkpoint
    def save(self, filename: str) -> None:
        meta = dict(n_learners=self.n_learners, custom_names=self.custom_names)
        with open(filename + ".gbrl_meta", "w") as f:
            json.dump(meta, f)
        for name, lr in zip(self.custom_names, self.learners):
            lr.save(f"{filename}_{name}")

    @classmethod
    def load(cls, filename: str, device: str = "cuda") -> "MultiGBTLearner":
        with open(filename + ".gbrl_meta") as f:
            meta = json.load(f)
        learners = [GBTLearner.load(f"{filename}_{name}", device)
                    for name in meta["custom_names"]]
        inst = cls.__new__(cls)
        first = learners[0]
        BaseLearner.__init__(inst, first.input_dim, first.output_dim,
                             first.tree_struct, None,
                             first.params, first.verbose, device)
        inst.optimizers = [lr.optimizers for lr in learners]
        inst.n_learners = meta["n_learners"]
        inst.custom_names = meta["custom_names"]
        inst.learners = learners
        inst.output_dim = first.output_dim
        return inst

    def __copy__(self) -> "MultiGBTLearner":
        inst = self.__class__.__new__(self.__class__)
        inst.__dict__.update(self.__dict__)
        inst.learners = [lr.copy() for lr in self.learners]
        return inst
