"""Host time of one iteration's rollout in the RL loop (rl/ppo.py
``collect_rollout``; rl/awr.py ``_rollout`` and ``_recompute_replay``,
with the host mirror's forwards), in ms, averaged over the iterations."""


def read(trace, run):
    its = trace.extra.get("iterations") or []
    if not its:
        return None
    return 1e3 * sum(i["rollout_s"] for i in its) / len(its)
