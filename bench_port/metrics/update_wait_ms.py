"""Host time one training iteration spends reading the update's results
back, which waits for the card to finish the update: the ``update.readback``
span (rl/jit_update.py) and the mirrors' ``mirror.sync`` spans after the
update (utils/host_mirror.py), in ms, averaged over the iterations."""
from bench_port.metrics import _program as P


def read(trace, run):
    recs = P.window(trace)
    its, syncs = P.in_iterations(recs, "mirror.sync")
    if not its:
        return None
    return (P.ms(P.named(recs, "update.readback")) + P.ms(syncs)) / len(its)
