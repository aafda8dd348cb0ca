"""Device operations (kernels, copies, sets) that start inside the update
spans, per tree fit there (ops/fit.py, ops/boosting.py,
ops/candidates.py)."""


def read(trace, run):
    its = trace.extra.get("iterations") or []
    trees = sum(i["trees"] for i in its)
    if not trees:
        return None
    iv = [x for i in its for x in i["update_iv"]]
    return trace.count_within(iv) / trees
