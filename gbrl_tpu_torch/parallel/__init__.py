"""Data-parallel boosting over ``torch.distributed``: samples shard over
ranks, ensembles are replicated (``sharded``), the RL update phases
(``sharded_rl``) and the multi-process entry points (``hosts``)."""
from .sharded import (make_mesh, shard_batch, replicate,  # noqa: F401
                      sharded_boost_step, sharded_train_step)
