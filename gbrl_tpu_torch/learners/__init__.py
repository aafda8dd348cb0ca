from .base import BaseLearner  # noqa: F401
from .gbt_learner import GBTLearner  # noqa: F401
from .multi_gbt_learner import MultiGBTLearner  # noqa: F401
from .actor_critic_learner import (SharedActorCriticLearner,  # noqa: F401
                                   SeparateActorCriticLearner)
