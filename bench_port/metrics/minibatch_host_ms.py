"""Host time of one minibatch of the fused updates (``minibatch`` spans:
one tree's gradients, candidates, fit, write and, in PPO, the incremental
prediction; rl/jit_update.py, rl/jit_awr.py), in ms, the mean over the
minibatches."""
from bench_port.metrics import _program as P


def read(trace, run):
    mbs = P.named(P.window(trace), "minibatch")
    if not mbs:
        return None
    return P.ms(mbs) / len(mbs)
