"""The least time of the update phases' work (bench_port/work) over the
device's busy time inside the update spans, whatever kernels do it, in %."""


def read(trace, run):
    its = trace.extra.get("iterations") or []
    busy = trace.busy_within([x for i in its for x in i["update_iv"]])
    if busy <= 0:
        return None
    return 100.0 * sum(i["least_s"]["update"] for i in its) / busy
