"""RL algorithms over GBT models (counterpart of ``gbrl_tpu/rl``; the
reference delegates algorithms to its companion repo GBRL_SB3, reference
README.md:19).

PPO and A2C train a shared actor-critic ensemble, AWR a Gaussian actor and
a value critic, SAC a tanh-Gaussian actor and twin parametric Q-critics, all
on the card: rollouts are served on the host by the ensemble mirrors
(utils/host_mirror.py) and each update runs on the device (``jit_update``,
``jit_a2c``, ``jit_awr``, ``jit_sac``).  SAC is EXPERIMENTAL, as in the JAX
package: it learns contextual-bandit tasks but does not solve Pendulum at
small tree budgets.
"""
from .buffers import NStepAccumulator, ReplayBuffer, RolloutBuffer  # noqa: F401
from .a2c import A2C  # noqa: F401
from .awr import AWR  # noqa: F401
from .ppo import PPO  # noqa: F401
from .sac import SAC  # noqa: F401
