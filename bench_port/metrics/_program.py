"""What the readers of the program's own spans and counters share: the
records that ``gbrl_tpu_torch.utils.profiling`` kept inside the traced
window.  A program without those records (an older commit) gives an empty
list, and its readers then return None."""
from __future__ import annotations


def window(trace) -> list:
    """The program's span records that lie inside the traced window."""
    try:
        from gbrl_tpu_torch.utils import profiling
    except ImportError:
        return []
    records = getattr(profiling, "records", None)
    if records is None:
        return []
    return [r for r in records() if r.t0 >= trace.t0 and r.t1 <= trace.t1]


def named(recs: list, *names: str) -> list:
    return [r for r in recs if r.name in names]


def in_iterations(recs: list, *names: str):
    """(the ``iteration`` spans, the spans of ``names`` directly under
    one)."""
    its = named(recs, "iteration")
    ids = {r.id for r in its}
    return its, [r for r in recs if r.name in names and r.parent in ids]


def ms(recs: list) -> float:
    return sum(r.t1 - r.t0 for r in recs) / 1e6


def syncs(recs: list) -> int:
    """Host waits for the card counted while the spans were open."""
    return sum(n for r in recs for k, n in r.counts.items()
               if k.startswith("sync."))
