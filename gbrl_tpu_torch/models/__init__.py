from .base import BaseGBT  # noqa: F401
from .actor_critic import ActorCritic  # noqa: F401
