"""Device time of the control-variate correction in one training
iteration: the busy time of the device operations that start inside the
program's ``cv`` spans (ops/boosting.py ``apply_control_variates``, in
rl/jit_a2c.py's update), in ms, averaged over the iterations.  A program
without the span reads None."""
from bench_port.metrics import _ops


def read(trace, run):
    return _ops.span_ms(trace, "cv")
