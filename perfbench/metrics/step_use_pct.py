"""The share of the sub-steps issued that an instance needed: the
instance-steps of the traced requests, each instance to its own stop
(the sum of ``steps``), over the ``step`` spans times the instances a
request, in %.  What it misses is the last chunk's overrun (K sub-steps a
chunk) and, on lanes, the frozen lanes computed behind the longest."""

from benchlib.spans import by_request

UNIT = "%"
BETTER = "higher"
SOURCE = "program_span"
LAYER = "engine: host chunk loop"
MOVES = "iter_per_s"
WORKLOADS = ["lasso_boyd_1500x5000.solve", "tv1d_65536.solve", "lasso_boyd_1500x5000.path100"]


def read(run):
    pairs = by_request(run)
    issued = sum(len(named.get("step", [])) * r.instances for r, named in pairs)
    if not issued:
        return None
    return 100.0 * sum(sum(r.steps) for r, _ in pairs) / issued
