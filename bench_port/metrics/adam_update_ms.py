"""Device time of the Adam delta in one training iteration: the busy time
of the device operations that start inside the program's ``adam`` spans
(optimizers.py ``adam_delta``, in rl/jit_a2c.py's update), in ms,
averaged over the iterations.  A program without the span reads None."""
from bench_port.metrics import _ops


def read(trace, run):
    return _ops.span_ms(trace, "adam")
