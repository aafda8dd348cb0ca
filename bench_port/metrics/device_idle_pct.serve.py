"""The share of the traced window in which no operation ran on the
device, in %, in a serving cell."""


def read(trace, run):
    if trace.window_s <= 0 or trace.busy_s <= 0:
        return None
    return 100.0 * (1.0 - trace.busy_s / trace.window_s)
