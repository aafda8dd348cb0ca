"""Tracing & profiling (counterpart of ``gbrl_tpu/utils/profiling.py``; the
reference only has stdout verbose prints, SURVEY §5).

- ``trace(logdir)``: context manager around torch.profiler; writes one
  Chrome / TensorBoard trace (``*.pt.trace.json``) into ``logdir``, with
  the card's kernels when CUDA is available.
- ``StepTimer``: lightweight named-phase wall-clock aggregation for training
  loops (host-side, never waits for the device; call ``report()`` for a
  summary).
- ``annotate(name)``: torch.profiler.record_function, so custom phases show
  in the trace viewer.
"""
from __future__ import annotations

import contextlib
import time
from collections import defaultdict
from typing import Dict, Iterator

import torch


@contextlib.contextmanager
def trace(logdir: str) -> Iterator[None]:
    """Capture a Chrome / TensorBoard trace of everything inside the block."""
    from torch.profiler import (ProfilerActivity, profile,
                                tensorboard_trace_handler)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities,
                 on_trace_ready=tensorboard_trace_handler(logdir)):
        yield


def annotate(name: str):
    return torch.profiler.record_function(name)


class StepTimer:
    """Aggregate wall-clock per named phase.

    >>> timer = StepTimer()
    >>> with timer("rollout"): ...
    >>> with timer("update"): ...
    >>> print(timer.report())
    """

    def __init__(self):
        self.totals: Dict[str, float] = defaultdict(float)
        self.counts: Dict[str, int] = defaultdict(int)

    @contextlib.contextmanager
    def __call__(self, name: str) -> Iterator[None]:
        t0 = time.perf_counter()
        try:
            yield
        finally:
            dt = time.perf_counter() - t0
            self.totals[name] += dt
            self.counts[name] += 1

    def report(self) -> str:
        lines = []
        total = sum(self.totals.values()) or 1.0
        for name, t in sorted(self.totals.items(), key=lambda kv: -kv[1]):
            n = self.counts[name]
            lines.append(f"{name:>16}: {t:8.3f}s total  "
                         f"{t / n * 1000:8.2f}ms/call  x{n}  "
                         f"{t / total * 100:5.1f}%")
        return "\n".join(lines)

    def reset(self) -> None:
        self.totals.clear()
        self.counts.clear()
