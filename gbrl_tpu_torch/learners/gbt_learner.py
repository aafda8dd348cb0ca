"""GBTLearner: single-ensemble learner (counterpart of
``gbrl_tpu/learners/gbt_learner.py``; reference gbrl/learners/gbt_learner.py).

Owns one ``Ensemble`` of torch tensors on ``device``, fits trees into it
(``step``: one boosting iteration on per-sample gradients; ``fit``: the
supervised loop; ``distil``) and serves predictions from it.  Checkpoints
are the JAX package's ``.gbrl_model`` format (npz with a JSON ``__meta__``),
so a checkpoint crosses between the two packages in both directions.  SHAP
runs on the ensemble's device (``ops/shap_device.py``); tree printing, the
C-header export and the reference-format writer read the ensemble on the
host (``utils/``).
"""
from __future__ import annotations

import hashlib
import json
from typing import Dict, List, Optional, Tuple, Union

import numpy as np
import torch

from ..common.utils import (CategoryVocab, NumericalData, ensure_2d,
                            ensure_leaf_output, get_index_mapping, is_torch,
                            preprocess_features, to_numpy)
from ..ensemble import (FIELDS, Ensemble, ensemble_from_numpy,
                        ensemble_to_numpy, ensure_capacity, init_ensemble)
from ..ops.boosting import (boost_step, fit_loop, predict_sgd,
                            tree_prediction)
from ..ops.predict import weighted_leaf_sum
from ..ops.shap_device import ensemble_shap_device
from ..ops.shap_refcompat import ensemble_shap_ref_compat
from ..optimizers import OptimizerSpec, adam_delta, scheduler_lr, sgd_coeff
from ..utils import introspection, profiling
from ..utils.c_export import export_ensemble_header
from ..utils.reference_export import export_reference_model
from .base import BaseLearner

SAVE_SUFFIX = ".gbrl_model"
# new trees since a cached prediction that are evaluated one by one; more
# than this and the cached prediction is topped up with one delta sum
MAX_SINGLE_TREE_UPDATES = 8
# the prediction cache's counters by the path a keyed call took
CACHE_COUNTERS = {"cached": "cache.hit", "delta": "cache.delta",
                  "full": "cache.miss"}


def _cache_key(inputs) -> Optional[bytes]:
    """Exact predict-cache key of a host input (a numpy array, a CPU tensor
    or a nested list): blake2b over its dtype, shape and every byte; None
    for inputs that are not keyed (CUDA tensors, whose bytes would have to
    be copied to the host, and (numeric, categorical) tuples).  The JAX
    package's opt-in strided key is not carried over."""
    if isinstance(inputs, tuple) or (is_torch(inputs)
                                     and inputs.device.type != "cpu"):
        return None
    a = np.ascontiguousarray(inputs.detach().numpy() if is_torch(inputs)
                             else np.asarray(inputs))
    if a.dtype == object:
        return None
    h = hashlib.blake2b(digest_size=16)
    h.update(f"{a.dtype.str}{a.shape}".encode())
    h.update(memoryview(a).cast("B"))
    return h.digest()


def _predict_full(cfg, ens: Ensemble, Xn, specs, start_tree: int,
                  stop_tree: int, Xc=None) -> torch.Tensor:
    preds = predict_sgd(cfg, ens, Xn, specs, start_tree, stop_tree, Xc)
    for spec in specs:
        if spec.algo == "Adam":
            preds = preds - adam_delta(cfg, ens, Xn, spec, start_tree,
                                       stop_tree, Xc)
    return preds


def _predict_delta(cfg, ens: Ensemble, Xn, specs,
                   start_tree: int) -> torch.Tensor:
    """Bias-free sum of SGD tree updates over [start_tree, n_trees) — the
    incremental part added on top of a cached prediction."""
    coeff = sgd_coeff(specs, ens.capacity, cfg.output_dim, ens.n_trees,
                      start_tree, ens.capacity)
    return weighted_leaf_sum(cfg, ens, Xn, coeff)


def _predict_one_tree(cfg, ens: Ensemble, Xn, specs, t: int) -> torch.Tensor:
    """SGD update of the single tree at index t: O(N * depth) work
    regardless of ensemble size."""
    tree = dict(feat=ens.feat[t], thr=ens.thr[t], cat_code=ens.cat_code[t],
                is_split=ens.is_split[t], is_numeric=ens.is_numeric[t],
                leaf_values=ens.leaf_values[t])
    tt = torch.tensor(t, dtype=torch.int32, device=Xn.device)
    return tree_prediction(cfg, specs, tree, tt, Xn)


class GBTLearner(BaseLearner):
    def __init__(self, input_dim: int, output_dim: int, tree_struct: Dict,
                 optimizers: Union[Dict, List[Dict], None],
                 params: Dict = None, verbose: int = 0, device: str = "cuda",
                 policy_dim: int = 0, name: str = "GBRL"):
        super().__init__(input_dim, output_dim, tree_struct, optimizers,
                         params, verbose, device)
        self.learner_name = name
        if policy_dim:
            self.cfg = self.cfg.replace(policy_dim=policy_dim)
        self.ens: Optional[Ensemble] = None
        self.specs: Tuple[OptimizerSpec, ...] = ()
        self.feature_weights = np.ones(input_dim, dtype=np.float32)
        fw = self.params.get("feature_weights")
        if fw is not None:
            fw = np.asarray(fw, dtype=np.float32).reshape(-1)
            assert len(fw) == input_dim, \
                "feature weights dim must equal input dim"
            assert (fw >= 0).all(), "feature weights must be non-negative"
            self.feature_weights = fw
        self.vocab: Optional[CategoryVocab] = None
        self._mapping_set = False
        self.num_mask = np.ones(input_dim, dtype=bool)   # original-order mask
        self.total_iterations = 0
        self._pred_cache = None   # (input-hash, n_trees, preds) for SGD delta
        # the RL loops' host copy of n_trees (None: not tracked; the loops
        # arm it and then own every change to the ensemble while training)
        self._rl_host_n_trees: Optional[int] = None

    # ------------------------------------------------------------------ setup
    def reset(self) -> None:
        if self.optimizers is not None:
            self.specs = tuple(OptimizerSpec.from_dict(o)
                               for o in self.optimizers)
            self._validate_specs()
        self.ens = init_ensemble(self.cfg, device=self.torch_device)
        self._mapping_set = False
        self.total_iterations = 0
        self._pred_cache = None
        self._rl_host_n_trees = None

    def _validate_specs(self) -> None:
        """Column-range validation (reference: gbrl.cpp:452-525)."""
        assert len(self.specs) <= self.output_dim, \
            "number of optimizers must be <= output_dim"
        for s in self.specs:
            assert 0 <= s.start_idx < s.stop_idx <= self.output_dim, \
                f"optimizer range [{s.start_idx}, {s.stop_idx}) invalid for " \
                f"output_dim {self.output_dim}"

    def set_feature_mapping(self, num_mask: np.ndarray) -> None:
        """Record which original columns are numeric."""
        num_mask = np.asarray(num_mask, dtype=bool)
        assert len(num_mask) == self.input_dim
        self.num_mask = num_mask
        n_num = int(num_mask.sum())
        n_cat = self.input_dim - n_num
        self.cfg = self.cfg.replace(n_num_features=n_num, n_cat_features=n_cat)
        if n_cat > 0 and self.vocab is None:
            self.vocab = CategoryVocab(n_cat)
        self._mapping_set = True

    def _host_feature_weights(self) -> np.ndarray:
        """Per-internal-feature weights in [num block | cat block] order,
        mapped through the original column positions (both grow
        policies), as a host array."""
        order = np.concatenate([np.where(self.num_mask)[0],
                                np.where(~self.num_mask)[0]])
        return np.ascontiguousarray(self.feature_weights[order], np.float32)

    def _internal_feature_weights(self) -> torch.Tensor:
        """``_host_feature_weights`` on the learner's device."""
        profiling.count_sync("feature_weights",
                             self.torch_device.type == "cuda")
        return torch.from_numpy(self._host_feature_weights()).to(
            self.torch_device)

    def _n_codes(self) -> int:
        """Categorical code-space bound, padded to a power of two (>= 8)."""
        if self.vocab is None:
            return 0
        mx = max((len(m) for m in self.vocab.maps), default=0)
        n = 8
        while n < mx:
            n *= 2
        return n

    def _grads_tensor(self, grads, n: int) -> torch.Tensor:
        """Gradients (an array or tensor, or a tuple of them concatenated
        along the columns) -> [n, O] f32 on the learner's device."""
        parts = grads if isinstance(grads, tuple) else (grads,)
        ts = [g.detach().to(self.torch_device, torch.float32).reshape(n, -1)
              if is_torch(g) else
              torch.from_numpy(to_numpy(g).reshape(n, -1)).to(self.torch_device)
              for g in parts]
        return torch.cat(ts, dim=1) if len(ts) > 1 else ts[0].contiguous()

    def _infer_mapping_from(self, inputs) -> None:
        if self._mapping_set:
            return
        _, num_mask = get_index_mapping(inputs)
        if len(num_mask) != self.input_dim:
            # tuple input or already-split data: assume numeric-first layout
            num, _ = preprocess_features(inputs)
            n_num = 0 if num is None else num.shape[1]
            num_mask = np.zeros(self.input_dim, dtype=bool)
            num_mask[:n_num] = True
        self.set_feature_mapping(num_mask)

    def _disambiguate_1d(self, inputs):
        """1D input of length input_dim is one sample; otherwise it is a
        column of input_dim == 1 (binding.cpp:820-930)."""
        if isinstance(inputs, tuple):
            return inputs
        if not hasattr(inputs, "ndim"):
            inputs = np.asarray(inputs)
        if inputs.ndim == 1:
            if len(inputs) == self.input_dim and self.input_dim > 1:
                return inputs.reshape(1, -1)
            return inputs.reshape(-1, 1)
        return inputs

    def _prepare(self, inputs, grow_vocab: bool):
        """inputs -> (Xn [N, Fn], Xc codes [N, Fc] | None), tensors on the
        learner's device (a CUDA input is not copied through the host)."""
        inputs = self._disambiguate_1d(inputs)
        self._infer_mapping_from(inputs)
        if is_torch(inputs) and inputs.device.type != "cpu":
            Xn = inputs.detach().to(self.torch_device, torch.float32)
            return Xn.reshape(Xn.shape[0], -1).contiguous(), None
        num, cat = preprocess_features(inputs)
        if num is None:
            num = np.zeros((cat.shape[0], 0), dtype=np.float32)
        on_card = self.torch_device.type == "cuda"
        # copies from pageable host memory wait for the card
        profiling.count_sync("prepare", on_card)
        Xn = torch.from_numpy(num).to(self.torch_device)
        if cat is None or cat.shape[1] == 0:
            return Xn, None
        codes = self.vocab.encode(cat, grow=grow_vocab)
        profiling.count_sync("prepare_codes", on_card)
        return Xn, torch.from_numpy(codes).to(self.torch_device)

    # ------------------------------------------------------------------ train
    def step(self, inputs: NumericalData, grads: NumericalData) -> None:
        """One boosting iteration on per-sample gradients (reference:
        gbt_learner.py:105-148 -> GBRL::step -> Fitter::step_cpu)."""
        assert self.ens is not None, "call reset() first"
        Xn, Xc = self._prepare(inputs, grow_vocab=True)
        n = Xn.shape[0] if Xn.shape[1] > 0 else Xc.shape[0]
        g = self._grads_tensor(grads, n)
        assert g.shape[1] == self.output_dim, \
            f"grads dim {g.shape[1]} != output_dim {self.output_dim}"
        self.ens = ensure_capacity(self.ens, self.get_num_trees() + 1)
        fw = self._internal_feature_weights()
        n_num = self.cfg.n_num_features
        self.ens = boost_step(self.cfg, self.ens, Xn, g, fw[:n_num], Xc,
                              fw[n_num:], self._n_codes())
        self.total_iterations += 1
        if self._rl_host_n_trees is not None:
            self._rl_host_n_trees += 1   # keep the RL host counter exact

    def fit(self, features: NumericalData, targets: NumericalData,
            iterations: int, shuffle: bool = True,
            loss_type: str = "MultiRMSE", seed: int = 42) -> float:
        """Supervised multi-iteration fit (reference: gbt_learner.py:150-183,
        GBRL::fit gbrl.cpp:983-1104: SGD only, host-side shuffle,
        bias = mean(targets), cycling mini-batches)."""
        assert self.ens is not None, "call reset() first"
        assert loss_type == "MultiRMSE", "only MultiRMSE is implemented"
        for s in self.specs:
            if s.algo == "Adam":
                raise RuntimeError(
                    "Adam optimizer not supported in fit function. Use SGD")
        num, cat = preprocess_features(features)
        self._infer_mapping_from(features)
        y = ensure_2d(to_numpy(targets))
        codes = None
        if cat is not None:
            codes = self.vocab.encode(cat, grow=True)
        X = num if num is not None else np.zeros((y.shape[0], 0), np.float32)
        N = X.shape[0]
        if shuffle:
            perm = np.random.default_rng(seed).permutation(N)
            X, y = X[perm], y[perm]
            if codes is not None:
                codes = codes[perm]
        bs = min(self.cfg.batch_size, N)
        n_pad = ((N + bs - 1) // bs) * bs
        Xp = np.zeros((n_pad, X.shape[1]), dtype=np.float32)
        yp = np.zeros((n_pad, y.shape[1]), dtype=np.float32)
        Xp[:N], yp[:N] = X, y
        dev = self.torch_device
        Xcp = None
        if codes is not None:
            # padded rows reuse row 0's codes; masked out of counts and loss
            Xcp = np.zeros((n_pad, codes.shape[1]), dtype=np.int32)
            Xcp[:N] = codes
            Xcp[N:] = codes[0] if N > 0 else 0
            Xcp = torch.from_numpy(Xcp).to(dev)
        self.ens = ensure_capacity(self.ens, self.get_num_trees() + iterations)
        self.ens = self.ens.replace(bias=torch.from_numpy(
            np.ascontiguousarray(y.mean(axis=0), np.float32)).to(dev))
        self._pred_cache = None
        self._bias_version = getattr(self, "_bias_version", 0) + 1
        fw = self._internal_feature_weights()
        n_num = self.cfg.n_num_features
        self.ens, loss, per_iter = fit_loop(
            self.cfg, int(iterations), self.ens, torch.from_numpy(Xp).to(dev),
            torch.from_numpy(yp).to(dev), N, self.specs, fw[:n_num], Xcp,
            fw[n_num:], self._n_codes())
        self._last_fit_losses = per_iter.cpu().numpy()
        if self._rl_host_n_trees is not None:
            self._rl_host_n_trees += int(iterations)
        if self.verbose > 0:
            # per-iteration batch loss (fitter.cpp:232-234)
            for i, l in enumerate(self._last_fit_losses):
                print(f"Boosting iteration: {i + 1} - MultiRMSE Loss: {l}")
        self.total_iterations += int(iterations)
        return float(loss)

    def distil(self, obs, targets, params: Dict, verbose: int = 0):
        """Train a compact student on this ensemble's outputs and swap it in
        (reference: gbt_learner.py:502-551)."""
        student_struct = dict(self.tree_struct)
        student_struct["max_depth"] = params.get(
            "max_depth", student_struct.get("max_depth", 4))
        lr = params.get("lr", 1.0)
        student = GBTLearner(
            self.input_dim, self.output_dim, student_struct,
            [dict(algo="SGD", init_lr=lr, start_idx=0,
                  stop_idx=self.output_dim, scheduler="Const")],
            {k: v for k, v in self.params.items() if k != "feature_weights"},
            verbose, self.device)
        student.reset()
        loss = student.fit(obs, targets,
                           params.get("distil_budget", 1000), shuffle=False)
        old_bv = getattr(self, "_bias_version", 0)
        self.__dict__.update(student.__dict__)
        self._pred_cache = None
        # the ensemble changed wholesale: the RL host counter is disarmed,
        # and the bias version moves past anything a mirror has seen
        self._rl_host_n_trees = None
        self._bias_version = max(old_bv,
                                 getattr(student, "_bias_version", 0)) + 1
        return loss, params

    # -------------------------------------------------------------- inference
    def _predict_raw(self, inputs, start_idx: int = 0,
                     stop_idx: Optional[int] = None) -> torch.Tensor:
        """Predictions [N, output_dim] on the learner's device.

        Full-range SGD predictions on a repeated host input are served
        incrementally: only trees added since the cached call are evaluated
        (leaf values are immutable once fit, so cache + delta reproduces a
        full predict): up to MAX_SINGLE_TREE_UPDATES new trees one by one,
        more as one delta sum.

        The cache key is an exact blake2b hash of the host bytes.  Only host
        inputs (numpy arrays, CPU tensors) are keyed: hashing a CUDA tensor
        would copy it to the host, so a CUDA input is always predicted in
        full (the RL loops pass host arrays).

        Each call counts ``cache.hit`` (the cached prediction answers),
        ``cache.delta`` (cache plus the new trees), ``cache.miss`` (keyed,
        predicted in full) or ``cache.unkeyed``, and is recorded as a
        ``predict`` span (rows, path ``cached`` / ``delta`` / ``full``)
        holding ``prepare``, ``cache_key``, ``n_trees`` and
        ``ensemble_sum`` (utils/profiling.py)."""
        assert self.ens is not None, "call reset() first"
        span = profiling.spanner()
        with span("predict"):
            with span("prepare"):
                Xn, Xc = self._prepare(inputs, grow_vocab=False)
            key = n_trees = None
            if ((start_idx in (0, None)) and (stop_idx in (None, 0))
                    and Xc is None and all(s.algo == "SGD"
                                           for s in self.specs)):
                with span("cache_key"):
                    key = _cache_key(inputs)
            if key is not None:
                with span("n_trees"):
                    n_trees = self.get_num_trees()
            with span("ensemble_sum"):
                preds, path = self._ensemble_sum(Xn, Xc, key, n_trees,
                                                 start_idx, stop_idx)
            profiling.count("cache.unkeyed" if key is None
                            else CACHE_COUNTERS[path])
            profiling.tag(rows=Xn.shape[0], path=path)
            if key is not None:
                self._pred_cache = (key, n_trees, preds)
            return preds

    def _ensemble_sum(self, Xn, Xc, key, n_trees: Optional[int],
                      start_idx: int, stop_idx: Optional[int]):
        """(predictions, path): the cached prediction of the same key
        ("cached"), it plus the trees added since ("delta"), or a full
        predict ("full")."""
        if key is not None and self._pred_cache is not None:
            ckey, cn, cpred = self._pred_cache
            if ckey == key and cn <= n_trees and \
                    cpred.shape[0] == Xn.shape[0]:
                if cn == n_trees:
                    return cpred, "cached"
                if n_trees - cn <= MAX_SINGLE_TREE_UPDATES:
                    preds = cpred
                    for t in range(cn, n_trees):
                        preds = preds + _predict_one_tree(
                            self.cfg, self.ens, Xn, self.specs, t)
                    return preds, "delta"
                return cpred + _predict_delta(self.cfg, self.ens, Xn,
                                              self.specs, cn), "delta"
        stop = stop_idx if stop_idx else int(self.ens.capacity)
        return _predict_full(self.cfg, self.ens, Xn, self.specs,
                             start_idx or 0, stop, Xc), "full"

    def predict(self, inputs: NumericalData, requires_grad: bool = True,
                start_idx: int = 0, stop_idx: Optional[int] = None,
                tensor: bool = True):
        """Ensemble prediction over trees [start_idx, stop_idx)
        (reference: gbt_learner.py:455-500).  Returns a leaf tensor on the
        learner's device (``requires_grad`` as asked) or a numpy array."""
        out = self._predict_raw(inputs, start_idx, stop_idx)
        if self.output_dim == 1:
            out = out.reshape(-1)     # binding.cpp:282-283: 1D for out_dim 1
        return ensure_leaf_output(out, tensor, requires_grad)

    def predict_async(self, inputs: NumericalData) -> torch.Tensor:
        """Full-ensemble prediction [N, output_dim] on the device, returned
        as soon as the work is queued: CUDA launches are asynchronous, so
        the caller overlaps host work until it reads the result."""
        assert self.ens is not None, "call reset() first"
        Xn, Xc = self._prepare(inputs, grow_vocab=False)
        return _predict_full(self.cfg, self.ens, Xn, self.specs, 0,
                             int(self.ens.capacity), Xc)

    # ----------------------------------------------------------- introspection
    def get_iteration(self) -> int:
        return self.get_num_trees()

    def get_num_trees(self) -> int:
        if self.ens is None:
            return 0
        profiling.count_sync("n_trees", self.ens.n_trees.is_cuda)
        return int(self.ens.n_trees)

    def get_total_iterations(self) -> int:
        return self.total_iterations

    def get_schedule_learning_rates(self):
        t = torch.tensor(self.get_iteration(), dtype=torch.int32)
        lrs = [float(scheduler_lr(s, t)) for s in self.specs]
        return lrs[0] if len(lrs) == 1 else tuple(lrs)

    def get_optimizers(self) -> list:
        """Optimizer configuration as a list of dicts, one per optimizer,
        with the reference binding's field names (binding.cpp:393-419)."""
        return [dict(algo=s.algo, init_lr=float(s.init_lr),
                     start_idx=int(s.start_idx),
                     stop_idx=int(s.stop_idx) if s.stop_idx
                     else self.output_dim,
                     scheduler_func=s.scheduler, stop_lr=float(s.stop_lr),
                     T=int(s.T), beta_1=float(s.beta_1),
                     beta_2=float(s.beta_2), eps=float(s.eps))
                for s in self.specs]

    def set_bias(self, bias) -> None:
        b = to_numpy(bias).reshape(-1)
        assert len(b) == self.output_dim, \
            f"bias length {len(b)} != output_dim {self.output_dim}"
        self.ens = self.ens.replace(
            bias=torch.from_numpy(b.copy()).to(self.torch_device))
        self._pred_cache = None   # bias is baked into cached predictions
        self._bias_version = getattr(self, "_bias_version", 0) + 1

    def get_bias(self) -> np.ndarray:
        return self.ens.bias.cpu().numpy()

    def set_feature_weights(self, feature_weights) -> None:
        if np.isscalar(feature_weights):
            fw = np.full(self.input_dim, feature_weights, dtype=np.float32)
        else:
            fw = to_numpy(feature_weights).reshape(-1)
        assert len(fw) == self.input_dim, \
            "feature weights dim must equal input dim"
        assert (fw >= 0).all(), "feature weights must be non-negative"
        self.feature_weights = fw

    def get_feature_weights(self) -> np.ndarray:
        return self.feature_weights.copy()

    def get_metadata(self) -> Dict:
        """Metadata dict (analog of binding.cpp get_metadata:309-328)."""
        return introspection.get_ensemble_metadata(self.cfg, self.ens)

    def get_ensemble_data(self) -> Dict[str, np.ndarray]:
        """The fitted trees' SoA arrays as numpy (binding.cpp:330-390)."""
        return introspection.get_ensemble_data(self.cfg, self.ens)

    def set_device(self, device) -> None:
        """Moves the ensemble's tensors to ``device`` ("cpu" / "cuda"); the
        cached prediction is dropped.  Asking for CUDA without a card
        raises."""
        super().set_device(device)
        if self.ens is not None:
            self.ens = self.ens.replace(**{
                f: getattr(self.ens, f).to(self.torch_device)
                for f in FIELDS})
        self._pred_cache = None

    def print_ensemble_metadata(self) -> None:
        c = self.cfg
        print(f"GBRL-TPU ensemble: trees={self.get_num_trees()} "
              f"output_dim={c.output_dim} max_depth={c.max_depth} "
              f"n_bins={c.n_bins} policy={c.grow_policy} "
              f"score={c.split_score_func} generator={c.generator_type} "
              f"cv={c.use_control_variates}")

    def print_tree(self, tree_idx: int) -> None:
        print(introspection.format_tree(self.cfg, self.ens, tree_idx))

    def plot_tree(self, tree_idx: int, filename: str) -> None:
        introspection.plot_tree(self.cfg, self.ens, tree_idx, filename)

    def _shap(self, features, ref_compat: bool,
              tree_idx: Optional[int]) -> np.ndarray:
        Xn, Xc = self._prepare(features, grow_vocab=False)
        if ref_compat:
            return ensemble_shap_ref_compat(
                self.cfg, self.ens, Xn.cpu().numpy(),
                None if Xc is None else Xc.cpu().numpy(), tree_idx=tree_idx)
        return ensemble_shap_device(self.cfg, self.ens, Xn, Xc,
                                    self.input_dim, tree_idx).cpu().numpy()

    def tree_shap(self, tree_idx: int, features,
                  ref_compat: bool = False) -> np.ndarray:
        """SHAP values of one tree [N, input_dim, output_dim], computed on
        the ensemble's device (the reference is CPU-only here,
        gbrl.cpp:1271-1278).

        ``ref_compat=True`` instead reproduces the reference C++
        implementation bit-for-bit on the host, including its
        nearest-ancestor convention for repeated path features, which
        deviates from exact Shapley (see ops/shap_refcompat.py)."""
        return self._shap(features, ref_compat, tree_idx)

    def shap(self, features, ref_compat: bool = False) -> np.ndarray:
        """Ensemble SHAP values [N, input_dim, output_dim].

        Default: exact path-dependent TreeSHAP on the ensemble's device
        (matches brute-force Shapley enumeration and the ``shap`` package's
        TreeExplainer semantics).  ``ref_compat=True`` reproduces the
        reference C++ outputs exactly (ops/shap_refcompat.py)."""
        return self._shap(features, ref_compat, None)

    def export(self, filename: str, modelname: Optional[str] = None,
               export_format: str = "float",
               export_type: str = "full") -> None:
        """Self-contained C-header inference export (types.cpp:409-676);
        export_type 'compact' emits per-level tables for oblivious trees
        (types.h:170-174)."""
        export_ensemble_header(self.cfg, self.ens, filename,
                               modelname or "gbrl_model", self.specs,
                               export_format, export_type, self.vocab)

    def save_reference_format(self, filename: str) -> None:
        """Write a reference-compatible binary .gbrl_model
        (utils/reference_export.py; the bytes of the JAX package's writer)."""
        export_reference_model(self, filename)

    # ------------------------------------------------------------- checkpoint
    def save(self, filename: str) -> None:
        """Write the JAX package's ``.gbrl_model`` format."""
        filename = _with_suffix(filename)
        state = ensemble_to_numpy(self.ens)
        meta = dict(
            input_dim=self.input_dim, output_dim=self.output_dim,
            tree_struct=self.tree_struct, params={
                k: v for k, v in self.params.items()
                if k != "feature_weights"},
            optimizers=self.optimizers, verbose=self.verbose,
            device=self.device, total_iterations=self.total_iterations,
            num_mask=self.num_mask.tolist(),
            mapping_set=self._mapping_set,
            vocab=self.vocab.to_state() if self.vocab else None,
        )
        with open(filename, "wb") as f:
            np.savez_compressed(
                f, __meta__=np.frombuffer(
                    json.dumps(meta).encode(), dtype=np.uint8),
                feature_weights=self.feature_weights, **state)

    @classmethod
    def load(cls, filename: str, device: str = "cuda") -> "GBTLearner":
        """Read a ``.gbrl_model`` written by either package onto ``device``."""
        filename = _with_suffix(filename)
        with np.load(filename, allow_pickle=False) as data:
            meta = json.loads(bytes(data["__meta__"]).decode())
            arrs = {k: data[k] for k in FIELDS}
            feature_weights = data["feature_weights"].copy()
        learner = GBTLearner(input_dim=meta["input_dim"],
                             output_dim=meta["output_dim"],
                             tree_struct=meta["tree_struct"],
                             optimizers=meta["optimizers"],
                             params=meta["params"], verbose=meta["verbose"],
                             device=device)
        learner.reset()
        learner.ens = ensemble_from_numpy(arrs, learner.torch_device)
        learner.feature_weights = feature_weights
        learner.total_iterations = meta["total_iterations"]
        if meta["mapping_set"]:
            learner.set_feature_mapping(np.asarray(meta["num_mask"], bool))
        if meta["vocab"] is not None:
            learner.vocab = CategoryVocab.from_state(meta["vocab"])
        return learner

    def __copy__(self) -> "GBTLearner":
        c = GBTLearner(self.input_dim, self.output_dim, dict(self.tree_struct),
                       [dict(o) for o in self.optimizers] if self.optimizers
                       else None, dict(self.params), self.verbose, self.device)
        c.cfg = self.cfg
        c.specs = self.specs
        c.ens = self.ens          # predict never writes the tensors in place
        c.feature_weights = self.feature_weights.copy()
        c.num_mask = self.num_mask.copy()
        c._mapping_set = self._mapping_set
        c.vocab = (CategoryVocab.from_state(self.vocab.to_state())
                   if self.vocab else None)
        c.total_iterations = self.total_iterations
        return c


def _with_suffix(filename: str) -> str:
    return filename if filename.endswith(SAVE_SUFFIX) else filename + SAVE_SUFFIX
