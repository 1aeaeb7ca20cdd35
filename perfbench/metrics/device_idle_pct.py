"""The device's idle share of the traced span: 1 - (the union of every
device operation's interval) / (from the first traced request's start
to the last one's end), in %."""

from benchlib.trace import union_seconds

UNIT = "%"
BETTER = "lower"
SOURCE = "device_trace"
LAYER = "device"
MOVES = "iter_per_s"
WORKLOADS = ["lasso_boyd_1500x5000.solve", "tv1d_65536.solve", "lasso_boyd_1500x5000.path100"]


def read(run):
    if run.trace is None or not run.trace.requests:
        return None
    lo, hi = run.trace.span
    return 100.0 * (1.0 - union_seconds(run.trace.device, lo, hi) / (hi - lo))
