"""Spans, counters and the device trace of a traced run (``--trace 1``).

Spans are recorded from outside the program, around the calls into its
layers that an agent module names: each wrapper keeps a host-clock
interval (``time.time_ns``, the clock the profiler's timeline uses), its
depth, what the work of the span depends on, and the host synchronisations
PyTorch reports inside it under ``set_sync_debug_mode("warn")``.  The
device's intervals come from ``torch.profiler`` (CUPTI): kernels, copies
and sets.  Nothing here runs in an untraced run."""
from __future__ import annotations

import contextlib
import functools
import importlib
import time
import warnings

import numpy as np

SYNC_NOTICE = "called a synchronizing CUDA operation"


class Spans:
    def __init__(self):
        self.records = []
        self.depth = 0
        self.syncs = 0
        self._undo = []

    @contextlib.contextmanager
    def span(self, name: str, ctx: dict = None):
        import torch
        rec = dict(name=name, depth=self.depth, ctx=ctx or {})
        s0 = self.syncs
        self.depth += 1
        rec["t0"] = time.time_ns()
        try:
            with torch.profiler.record_function("bench." + name):
                yield rec
        finally:
            rec["t1"] = time.time_ns()
            self.depth -= 1
            rec["syncs"] = self.syncs - s0
            self.records.append(rec)

    def wrap(self, module: str, attr: str, name: str, context=None) -> None:
        """Record a span around every call of ``module.attr`` (``attr`` may
        be ``Class.method``); ``context(first_argument)`` is read as the
        span starts."""
        owner = importlib.import_module(module)
        parts = attr.split(".")
        for p in parts[:-1]:
            owner = getattr(owner, p)
        orig = getattr(owner, parts[-1])
        spans = self

        @functools.wraps(orig)
        def wrapper(*args, **kwargs):
            ctx = context(args[0]) if context is not None and args else None
            with spans.span(name, ctx):
                return orig(*args, **kwargs)
        setattr(owner, parts[-1], wrapper)
        self._undo.append((owner, parts[-1], orig))

    def unwrap(self) -> None:
        for owner, attr, orig in reversed(self._undo):
            setattr(owner, attr, orig)
        self._undo.clear()

    @contextlib.contextmanager
    def count_syncs(self, device: str):
        """Count the synchronisations PyTorch reports while the block runs
        (its own notice that the mode does not see every one is not one);
        a CPU run has none to count."""
        import torch
        if device != "cuda":
            yield
            return

        def show(message, *args, **kwargs):
            if SYNC_NOTICE in str(message):
                self.syncs += 1
        with warnings.catch_warnings():
            warnings.simplefilter("always")
            warnings.showwarning = show
            torch.cuda.set_sync_debug_mode("warn")
            try:
                yield
            finally:
                torch.cuda.set_sync_debug_mode(0)


def device_events(prof):
    """(starts [n] ns, ends [n] ns, names) of the operations that ran on
    the device, from a finished ``torch.profiler.profile``."""
    from torch.autograd import DeviceType
    starts, ends, names = [], [], []
    for e in prof.profiler.kineto_results.events():
        if e.device_type() != DeviceType.CUDA or e.is_user_annotation():
            continue
        s = e.start_ns()
        starts.append(s)
        ends.append(s + e.duration_ns())
        names.append(e.name())
    order = np.argsort(np.asarray(starts, np.int64), kind="stable")
    return (np.asarray(starts, np.int64)[order],
            np.asarray(ends, np.int64)[order], [names[i] for i in order])


def union(starts: np.ndarray, ends: np.ndarray):
    """Merge sorted-by-start intervals: (starts, ends) of the union."""
    if len(starts) == 0:
        return starts, ends
    run_end = np.maximum.accumulate(ends)
    new = np.ones(len(starts), bool)
    new[1:] = starts[1:] > run_end[:-1]
    idx = np.flatnonzero(new)
    last = np.append(idx[1:] - 1, len(starts) - 1)
    return starts[idx], run_end[last]


class Trace:
    """What the per-layer readers read: the window, the spans, the
    device's operations and their union."""

    def __init__(self, window, spans: list, dev, extra: dict = None):
        self.t0, self.t1 = window
        self.spans = spans
        s, e, self.names = dev
        keep = (e > self.t0) & (s < self.t1)
        self.starts = np.clip(s[keep], self.t0, self.t1)
        self.ends = np.clip(e[keep], self.t0, self.t1)
        self.names = [n for n, k in zip(self.names, keep) if k]
        self.u0, self.u1 = union(self.starts, self.ends)
        self.extra = extra or {}

    @property
    def window_s(self) -> float:
        return (self.t1 - self.t0) / 1e9

    @property
    def busy_s(self) -> float:
        return float(np.sum(self.u1 - self.u0)) / 1e9

    def _busy_until(self, t: np.ndarray) -> np.ndarray:
        """Busy nanoseconds of the union before each time t."""
        cum = np.concatenate([[0], np.cumsum(self.u1 - self.u0)])
        j = np.searchsorted(self.u0, t, side="right")
        over = np.where(j > 0, self.u1[np.maximum(j - 1, 0)] - t, 0)
        return cum[j] - np.maximum(over, 0)

    def busy_within(self, intervals) -> float:
        """Seconds of the device's busy union inside host intervals."""
        if not intervals or len(self.u0) == 0:
            return 0.0
        iv = np.asarray(intervals, np.int64)
        return float(np.sum(self._busy_until(iv[:, 1])
                            - self._busy_until(iv[:, 0]))) / 1e9

    def count_within(self, intervals) -> int:
        """Device operations that start inside host intervals."""
        if not intervals:
            return 0
        iv = np.asarray(sorted(intervals), np.int64)
        pos = np.searchsorted(iv[:, 0], self.starts, side="right") - 1
        ok = pos >= 0
        return int(np.sum(self.starts[ok] < iv[pos[ok], 1]))

    def top_ops(self, n: int = 10) -> list:
        tot = {}
        for name, a, b in zip(self.names, self.starts, self.ends):
            tot[name] = tot.get(name, 0) + int(b - a)
        best = sorted(tot.items(), key=lambda kv: -kv[1])[:n]
        return [[k[:120], v / 1e9] for k, v in best]

    def idle_gaps(self, n: int = 10) -> list:
        """The longest gaps of the device inside the window, each named by
        the innermost span around its middle."""
        a = np.concatenate([[self.t0], self.u1])
        b = np.concatenate([self.u0, [self.t1]])
        order = np.argsort(a - b, kind="stable")[:n]
        out = []
        for length, lo, hi in zip((b - a)[order], a[order], b[order]):
            mid = (lo + hi) // 2
            inner = [s for s in self.spans if s["t0"] <= mid < s["t1"]]
            name = (max(inner, key=lambda s: s["depth"])["name"] if inner
                    else "between spans")
            out.append([name, int(length) / 1e9])
        return out
