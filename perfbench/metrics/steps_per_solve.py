"""ADMM steps to each instance's own Boyd stop: the mean of the steps the
entry returned, per instance (per lane of a path), over the window's
untraced requests."""

UNIT = "steps"
BETTER = "lower"
SOURCE = "program_counter"
LAYER = "solver"
MOVES = "solves_per_s"
WORKLOADS = ["lasso_boyd_1500x5000.solve", "tv1d_65536.solve", "lasso_boyd_1500x5000.path100"]


def read(run):
    steps = [k for r in run.untraced if not r.failed for k in r.steps]
    return sum(steps) / len(steps) if steps else None
