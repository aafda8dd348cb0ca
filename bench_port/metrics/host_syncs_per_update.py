"""Host synchronisations PyTorch reports (``set_sync_debug_mode("warn")``)
inside one iteration's update and mirror sync, averaged over the
iterations."""


def read(trace, run):
    its = trace.extra.get("iterations") or []
    if not its:
        return None
    return sum(i["syncs"] for i in its) / len(its)
