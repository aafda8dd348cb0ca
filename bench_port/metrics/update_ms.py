"""Host time of one iteration's fused update (rl/jit_update.py,
rl/jit_awr.py), from the update call to the end of the mirror sync that
waits for its trees, in ms, averaged over the iterations."""


def read(trace, run):
    its = trace.extra.get("iterations") or []
    if not its:
        return None
    return 1e3 * sum(i["update_s"] for i in its) / len(its)
