"""The least time of the Adam delta's work (bench_port/work/a2c.py
``adam``: the routing and the recurrence over the live trees, at the
span's rows and the policy columns) over the device's busy time of the
operations that start inside the program's ``adam`` spans, in %.  The live
trees are those of the update the span lies in, as the benchmark's update
span read them from the RL loop's host counter; the slots past them that
the walk masks are not work."""
from bench_port import peaks
from bench_port.metrics import _ops
from bench_port.metrics import _program as P
from bench_port.work import a2c as work


def read(trace, run):
    spans = P.named(P.window(trace), "adam")
    updates = [s for s in trace.spans if s["name"] == "update"]
    least = 0.0
    for r in spans:
        up = [u for u in updates if u["t0"] <= r.t0 < u["t1"]]
        if not up:
            continue
        least += peaks.least_seconds(*work.adam(
            run.cfg, r.attrs["rows"], up[0]["ctx"]["trees"]))
    busy = _ops.busy_of_ops(trace, [(r.t0, r.t1) for r in spans])
    if busy <= 0:
        return None
    return 100.0 * least / busy
