"""Host waits for the card that the program counts (``sync.<site>``
counters) inside the learner's top-level ``predict`` spans, per request."""
from bench_port.metrics import _program as P


def read(trace, run):
    requests = sum(1 for s in trace.spans if s["name"] == "request")
    calls = [r for r in P.named(P.window(trace), "predict")
             if r.parent is None]
    if not requests or not calls:
        return None
    return P.syncs(calls) / requests
