"""What the host did over a measured window, for the run's log: the
garbage collector's pauses, the process's CPU time (all its threads) and
involuntary context switches, and the share of the machine's CPU time the
hypervisor stole.  Nothing the run measures reads it."""
from __future__ import annotations

import gc
import os
import resource
import time


def _cpu_s() -> float:
    ru = resource.getrusage(resource.RUSAGE_SELF)
    return ru.ru_utime + ru.ru_stime


def _machine() -> tuple:
    """(stolen, total) jiffies of the machine so far; zeros where
    ``/proc/stat`` cannot be read."""
    try:
        with open("/proc/stat") as f:
            vals = [int(x) for x in f.readline().split()[1:]]
    except (OSError, ValueError):
        return 0, 0
    return (vals[7] if len(vals) > 7 else 0), sum(vals)


class Window:
    """Started on creation, stopped by ``close``; ``mark`` gives (wall s,
    CPU s, gc s) so far, for splitting the window into units."""

    def __init__(self):
        self.gc_s = 0.0
        self.gc_n = [0, 0, 0]
        self._gc_t = None
        gc.callbacks.append(self._on_gc)
        self._ru0 = resource.getrusage(resource.RUSAGE_SELF)
        self._m0 = _machine()
        self._t0 = time.perf_counter()
        self._cpu0 = _cpu_s()

    def _on_gc(self, phase: str, info: dict) -> None:
        if phase == "start":
            self._gc_t = time.perf_counter()
        elif self._gc_t is not None:
            self.gc_s += time.perf_counter() - self._gc_t
            self.gc_n[info["generation"]] += 1
            self._gc_t = None

    def mark(self) -> tuple:
        return (time.perf_counter() - self._t0, _cpu_s() - self._cpu0,
                self.gc_s)

    def close(self) -> None:
        self.wall_s, self.cpu_s, _ = self.mark()
        gc.callbacks.remove(self._on_gc)
        ru = resource.getrusage(resource.RUSAGE_SELF)
        self.nivcsw = ru.ru_nivcsw - self._ru0.ru_nivcsw
        m = _machine()
        self.steal = (m[0] - self._m0[0]) / max(m[1] - self._m0[1], 1)

    def report(self) -> str:
        return (f"gc {self.gc_s:.4f} s in {sum(self.gc_n)} collections "
                f"(generation 2: {self.gc_n[2]}); cpu {self.cpu_s:.3f} s of "
                f"{self.wall_s:.3f} s wall; {self.nivcsw} involuntary "
                f"switches; steal {100 * self.steal:.3f}% of the machine; "
                f"load {os.getloadavg()[0]:.2f} on {os.cpu_count()} cpus")
