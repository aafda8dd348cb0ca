"""What the readers of device time inside the program's spans share: the
device's busy time of the operations that start inside given host
intervals.  The card runs what the host enqueues a few microseconds after
the launch while the host is the slower side, as it is in the eager
updates, so an operation is credited to the span it was launched in."""
from __future__ import annotations

import numpy as np

from bench_port import tracing
from bench_port.metrics import _program as P


def busy_of_ops(trace, intervals) -> float:
    """Seconds of the union of the device operations whose start lies
    inside one of ``intervals`` (host [t0, t1) pairs, ns)."""
    if not intervals or len(trace.starts) == 0:
        return 0.0
    iv = np.asarray(sorted(intervals), np.int64)
    pos = np.searchsorted(iv[:, 0], trace.starts, side="right") - 1
    inside = np.zeros(len(trace.starts), bool)
    ok = pos >= 0
    inside[ok] = trace.starts[ok] < iv[pos[ok], 1]
    s, e = tracing.union(trace.starts[inside], trace.ends[inside])
    return float(np.sum(e - s)) / 1e9


def span_ms(trace, name: str):
    """Device ms of the operations started inside the program's ``name``
    spans, per iteration; None without such spans."""
    recs = P.window(trace)
    its = P.named(recs, "iteration")
    spans = P.named(recs, name)
    if not its or not spans:
        return None
    return 1e3 * busy_of_ops(trace, [(r.t0, r.t1) for r in spans]) / len(its)
