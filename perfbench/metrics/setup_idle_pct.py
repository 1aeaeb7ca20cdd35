"""The device's idle share of the entries' set-up, as the port marks it:
for each traced request, from the start of its first ``setup`` span to
the start of its ``loop`` span, 1 - (the union of the device operations
there) / (the interval's length), summed over the requests, in %.  The
device sync in ``prepare`` ends the interval, so the set-up's device work
(LASSO's Gram, LU and triangular solves) lies inside it."""

from benchlib.spans import by_request, device_busy
from benchlib.trace import Span

UNIT = "%"
BETTER = "lower"
SOURCE = "program_span"
LAYER = "models: entry set-up"
MOVES = "solves_per_s"
WORKLOADS = ["lasso_boyd_1500x5000.solve", "tv1d_65536.solve", "lasso_boyd_1500x5000.path100"]


def read(run):
    ivs = [Span("setup", named["setup"][0].t0, named["loop"][0].t0)
           for _, named in by_request(run) if named.get("setup")]
    total = sum(iv.dur for iv in ivs)
    if not total:
        return None
    return 100.0 * (1.0 - device_busy(run, ivs) / total)
