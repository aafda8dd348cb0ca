"""The least time of each iteration's work, the rollout's forwards and the
update's (bench_port/work), over the iteration's wall time, from its
rollout's start to its mirror sync's end, in % of the chip's peak."""


def read(trace, run):
    its = trace.extra.get("iterations") or []
    wall = sum(i["t1"] - i["t0"] for i in its) / 1e9
    if wall <= 0:
        return None
    least = sum(i["least_s"]["rollout"] + i["least_s"]["update"] for i in its)
    return 100.0 * least / wall
