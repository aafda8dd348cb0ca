"""Device operations (kernels, copies, sets) that start inside a request,
per request: the model facade, the learner and ops/predict.py."""


def _requests(trace):
    return [(s["t0"], s["t1"]) for s in trace.spans if s["name"] == "request"]


def read(trace, run):
    iv = _requests(trace)
    if not iv:
        return None
    return trace.count_within(iv) / len(iv)
