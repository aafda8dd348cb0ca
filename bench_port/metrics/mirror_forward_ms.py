"""Host time of the host mirror's forwards in one training iteration
(``mirror.forward`` spans of the rollout, ``mirror.range`` spans of AWR's
replay recompute: utils/host_mirror.py through rl/ppo.py and rl/awr.py),
in ms, averaged over the iterations."""
from bench_port.metrics import _program as P


def read(trace, run):
    recs = P.window(trace)
    its = P.named(recs, "iteration")
    if not its:
        return None
    return P.ms(P.named(recs, "mirror.forward", "mirror.range")) / len(its)
