"""The operations and bytes each kind of work needs, counted from its
shapes alone, whatever kernels the program runs for it.

The rule, for every file here: each add, subtract, multiply, divide,
compare, exp, log or square root on one value is one operation; each input
byte is read once and each output byte written once (a value the work
reuses is not counted again).  A least time is the larger of operations
over the peak float32 rate and bytes over the peak memory rate
(bench_port/peaks.py)."""
