"""RL algorithms over GBT models (counterpart of ``gbrl_tpu/rl``; the
reference delegates algorithms to its companion repo GBRL_SB3, reference
README.md:19).

PPO and A2C train a shared actor-critic ensemble on the card: rollouts are
served on the host by the ensemble mirror (utils/host_mirror.py) and each
update runs on the device (``jit_update``, ``jit_a2c``).  AWR and SAC come
with a later slice (ROADMAP.md) and raise when constructed.
"""
from ..learners.base import not_ported
from .buffers import NStepAccumulator, ReplayBuffer, RolloutBuffer  # noqa: F401
from .a2c import A2C  # noqa: F401
from .ppo import PPO  # noqa: F401


class AWR:
    """Advantage-weighted regression: not ported yet."""

    def __init__(self, *args, **kwargs):
        raise not_ported("AWR", "slice 4")


class SAC:
    """Soft actor-critic: not ported yet."""

    def __init__(self, *args, **kwargs):
        raise not_ported("SAC", "slice 4")
