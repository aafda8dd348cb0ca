from .base import BaseGBT  # noqa: F401
from .gbt import GBTModel  # noqa: F401
from .actor_critic import ActorCritic  # noqa: F401
from .actor import ParametricActor, GaussianActor  # noqa: F401
from .critic import ContinuousCritic, DiscreteCritic  # noqa: F401
