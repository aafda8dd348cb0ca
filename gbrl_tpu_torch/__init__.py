"""gbrl_tpu_torch — Gradient Boosted Trees for Reinforcement Learning in
PyTorch, with hand-written CUDA kernels for NVIDIA Hopper (H100).

A port of ``gbrl_tpu`` (the JAX/Pallas package, kept as the reference).
It imports ``torch`` and ``numpy`` only, never ``jax`` or ``gbrl_tpu``.
Every entry point takes ``device`` ("cuda" by default); asking for "cuda"
without a card raises.  It fits trees (``step``, ``fit``, ``distil``)
through the K1-K3 fit kernels (``csrc/fit.cu``) or, on the whole-tree path
(``ops.fit._DISABLE_FUSED_TREE = False``), one K6 launch per tree
(``csrc/tree.cu``); it serves predictions through the K4/K5 predict
kernels (``csrc/predict.cu``), all wrapped in ``ops/kernels.py``.  ``rl``
trains PPO, A2C, AWR and SAC on the card, their rollouts served by host
mirrors of the ensembles (``utils/host_mirror.py``, ``csrc/mirror.c``).
The learners explain an ensemble with TreeSHAP on its device
(``ops/shap_device.py``; ``ref_compat=True`` for the reference's values on
the host), print and plot its trees, export it as a C header served by a
native runtime (``utils/c_export.py``, ``utils/c_runtime.py``), and write
and read the reference's binary format (``utils/reference_export.py``,
``utils/reference_import.py``).  ``parallel`` trains over
``torch.distributed``, one process per rank: samples shard over the ranks,
the ensembles are replicated, K2's histograms (and every other
cross-sample sum) are summed over the ranks in rank order, so every rank
ends each step with the same ensemble (``parallel/sharded.py``); the PPO
and AWR update phases gather each minibatch's rows from their owners
(``parallel/sharded_rl.py``); ``parallel/hosts.py`` starts a rank from
explicit arguments or torchrun's variables and takes numpy shards.
"""
import torch as _torch

from .config import TreeConfig, APPROVED_OPTIMIZERS, VALID_OPTIMIZER_ARGS  # noqa: F401
from .ensemble import Ensemble, init_ensemble  # noqa: F401
from .optimizers import OptimizerSpec  # noqa: F401
from .models import (ActorCritic, ContinuousCritic, DiscreteCritic,  # noqa: F401
                     GaussianActor, GBTModel, ParametricActor)
from .learners import (GBTLearner, MultiGBTLearner,  # noqa: F401
                       SharedActorCriticLearner, SeparateActorCriticLearner)

__version__ = "0.1.0"


def cuda_available() -> bool:
    """True when PyTorch sees a CUDA device (reference: gbrl/__init__.py)."""
    return _torch.cuda.is_available()
