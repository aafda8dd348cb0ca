"""Host time of the learner's predict in a request (top-level ``predict``
spans, learners/gbt_learner.py ``_predict_raw``: preparing the rows, the
cache key, the tree count and the enqueue of the ensemble sum; the caller's
read of the outputs is outside), in ms, the mean over the calls."""
from bench_port.metrics import _program as P


def read(trace, run):
    calls = [r for r in P.named(P.window(trace), "predict")
             if r.parent is None]
    if not calls:
        return None
    return P.ms(calls) / len(calls)
