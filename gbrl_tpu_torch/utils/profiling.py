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
- ``span(name, **attrs)``: a span inside the program, recorded in memory
  while a torch profiler runs (``trace`` above, or any
  ``torch.profiler.profile``) and nothing otherwise.  A record holds the
  name, start and end on ``time.time_ns()`` (the clock of the profiler's
  timeline, so device intervals can be put inside spans), its id and its
  parent's, the attributes and the counts made while it was open.
  ``records()`` returns them, ``clear()`` empties them.
- ``count(name, n)``: an always-on counter (``counters()``); while spans
  record, the innermost open span is credited too.  The program counts
  ``launch.<kernel>`` (each call that launches a hand-written kernel, as
  ``ops.kernels.launch_counts``), ``sync.<site>`` (each call that makes
  the host wait for the card: a read of a CUDA tensor to the host, or a
  copy from pageable host memory to the card) and ``cache.hit`` /
  ``cache.delta`` / ``cache.miss`` / ``cache.unkeyed`` (the learners'
  prediction cache) and ``graph.capture`` / ``graph.replay`` /
  ``graph.eager`` (the fused updates' steps on the card: captured as a
  CUDA graph, replayed, or run as a capture's warm-up; ``rl/graphs.py``)
  and ``vocab.hit`` / ``vocab.miss`` / ``vocab.new_codes`` (categorical
  cells ``CategoryVocab.encode`` resolved by its table or by its
  per-feature path, and the codes it added; ``common/utils.py``).
  ``collect()`` holds counts back from a block (a graph's capture).
"""
from __future__ import annotations

import contextlib
import itertools
import time
from collections import defaultdict
from typing import Dict, Iterator, List, Optional

import torch
import torch.autograd.profiler as _autograd_profiler

# records kept before further spans are dropped (and counted as dropped)
RECORD_CAP = 1 << 20
# spans that also open a torch.profiler annotation, so a ``trace`` file
# shows them; the rest (one per env step, the request's spans) stay in
# memory only: an annotation costs the host tens of microseconds
ANNOTATED = frozenset({"rollout", "replay", "update", "minibatch", "fit"})


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


def recording() -> bool:
    """Whether spans record: exactly while a torch profiler runs."""
    return getattr(_autograd_profiler, "_is_profiler_enabled", False)


class SpanRecord:
    """One recorded span; ``t0`` / ``t1`` in ``time.time_ns()``, ``parent``
    the enclosing span's ``id`` (None at the top), ``counts`` what
    ``count`` added while the span was open, its children's included."""
    __slots__ = ("name", "id", "parent", "t0", "t1", "attrs", "counts")

    def __init__(self, name: str, id: int, parent: Optional[int],
                 attrs: dict):
        self.name = name
        self.id = id
        self.parent = parent
        self.attrs = attrs
        self.counts: Dict[str, int] = {}
        self.t0 = self.t1 = 0


class _Open:
    """The context of one recording span."""
    __slots__ = ("rec", "owner", "note")

    def __init__(self, owner: "Recorder", rec: SpanRecord):
        self.owner = owner
        self.rec = rec
        self.note = annotate(rec.name) if rec.name in ANNOTATED else None

    def __enter__(self) -> SpanRecord:
        if self.note is not None:
            self.note.__enter__()
        self.owner._stack.append(self.rec)
        self.rec.t0 = time.time_ns()
        return self.rec

    def __exit__(self, *exc) -> None:
        rec = self.rec
        rec.t1 = time.time_ns()
        stack = self.owner._stack
        stack.pop()
        if stack and rec.counts:
            up = stack[-1].counts
            for k, n in rec.counts.items():
                up[k] = up.get(k, 0) + n
        self.owner._keep(rec)
        if self.note is not None:
            self.note.__exit__(*exc)


_OFF = contextlib.nullcontext()


def _off(name: str, **attrs):
    return _OFF


class Recorder:
    """Spans and counters of one process (the module's functions below use
    one shared recorder)."""

    def __init__(self, cap: int = RECORD_CAP):
        self.cap = cap
        self.dropped = 0
        self._records: List[SpanRecord] = []
        self._stack: List[SpanRecord] = []
        self._ids = itertools.count(1)
        self._counters: Dict[str, int] = {}
        self._collecting: Optional[Dict[str, int]] = None

    def span(self, name: str, **attrs):
        """A context manager that records a span while a profiler runs;
        otherwise a shared do-nothing context."""
        if not recording():
            return _OFF
        parent = self._stack[-1].id if self._stack else None
        return _Open(self, SpanRecord(name, next(self._ids), parent, attrs))

    def spanner(self):
        """``span`` while a profiler runs, else a function returning the
        do-nothing context: loops read the flag once before they start."""
        return self.span if recording() else _off

    def tag(self, **attrs) -> None:
        """Add attributes to the innermost open span (none open: nothing)."""
        if self._stack:
            self._stack[-1].attrs.update(attrs)

    def count(self, name: str, n: int = 1) -> None:
        if self._collecting is not None:
            c = self._collecting
            c[name] = c.get(name, 0) + n
            return
        c = self._counters
        c[name] = c.get(name, 0) + n
        if self._stack:
            c = self._stack[-1].counts
            c[name] = c.get(name, 0) + n

    @contextlib.contextmanager
    def collect(self) -> Iterator[Dict[str, int]]:
        """Counts made inside the block go to the dict it yields, not to
        the counters or the spans: work that is recorded now and runs
        later (a CUDA graph's capture) is credited where it runs."""
        outer, self._collecting = self._collecting, {}
        try:
            yield self._collecting
        finally:
            self._collecting = outer

    def _keep(self, rec: SpanRecord) -> None:
        if len(self._records) < self.cap:
            self._records.append(rec)
        else:
            self.dropped += 1

    def records(self) -> List[SpanRecord]:
        """The closed spans, in the order they closed."""
        return list(self._records)

    def counters(self) -> Dict[str, int]:
        return dict(self._counters)

    def clear(self) -> None:
        """Forget the records and the dropped count (counters stay)."""
        self._records.clear()
        self.dropped = 0


RECORDER = Recorder()
span = RECORDER.span
spanner = RECORDER.spanner
tag = RECORDER.tag
count = RECORDER.count
collect = RECORDER.collect
records = RECORDER.records
counters = RECORDER.counters
clear = RECORDER.clear


def dropped() -> int:
    """Spans not kept since the last ``clear()``: the cap was reached."""
    return RECORDER.dropped


def count_sync(site: str, on_card: bool, n: int = 1) -> None:
    """Count ``n`` host waits for the card at ``site`` (``sync.<site>``),
    only where the tensor involved is on a CUDA device."""
    if on_card:
        count("sync." + site, n)


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
