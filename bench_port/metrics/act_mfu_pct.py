"""The least time of the requests' ensemble walks (bench_port/work) over
the requests' wall time, in % of the chip's peak."""


def read(trace, run):
    reqs = [s for s in trace.spans if s["name"] == "request"]
    wall = sum(s["t1"] - s["t0"] for s in reqs) / 1e9
    if wall <= 0:
        return None
    return 100.0 * sum(s["least_s"] for s in reqs) / wall
