"""The least time of the requests' ensemble walks (bench_port/work) over
the device's busy time inside the requests (K4 / K5 and what surrounds
them), in %."""


def read(trace, run):
    reqs = [s for s in trace.spans if s["name"] == "request"]
    busy = trace.busy_within([(s["t0"], s["t1"]) for s in reqs])
    if busy <= 0:
        return None
    return 100.0 * sum(s["least_s"] for s in reqs) / busy
