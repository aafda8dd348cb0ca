"""Device operations (kernels, copies, sets) that start inside the
program's ``fit`` spans (ops/fit.py ``build_tree``), per tree: the tree
fit's share of launches_per_tree.  An operation that the card starts after
its span closed is not counted."""
from bench_port.metrics import _program as P


def read(trace, run):
    fits = P.named(P.window(trace), "fit")
    if not fits:
        return None
    return trace.count_within([(r.t0, r.t1) for r in fits]) / len(fits)
