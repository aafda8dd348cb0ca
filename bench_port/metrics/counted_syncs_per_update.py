"""Host waits for the card that the program counts (``sync.<site>``
counters) inside one iteration's update and mirror syncs, averaged over
the iterations: the program's own count of what host_syncs_per_update
reads from PyTorch."""
from bench_port.metrics import _program as P


def read(trace, run):
    its, spans = P.in_iterations(P.window(trace), "update", "mirror.sync")
    if not its:
        return None
    return P.syncs(spans) / len(its)
