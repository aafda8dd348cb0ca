"""Per-layer metric readers, one file per metric, found by the metric's
name in BENCHMARK.json.  Each defines ``read(trace, run)``: the value from
the traced run's spans, counters and device trace (bench_port/tracing.py),
or None where the run has nothing to read."""
