"""Host launch calls of the sub-step's x-update: the launch calls
(``TraceSummary.launches``) starting inside the ``step.xupdate`` spans,
over the ``step`` spans (a lanes sub-step counts once).  The note gives
the x-update's launches, host time and device time per sub-step, the
device time joined to the phase through each launch's correlation id."""

from benchlib.spans import phase_launches

UNIT = "launches/substep"
BETTER = "lower"
SOURCE = "program_span"
LAYER = "engine: step x-update"
MOVES = "iter_per_s"
WORKLOADS = ["lasso_boyd_1500x5000.solve", "tv1d_65536.solve", "lasso_boyd_1500x5000.path100"]


def read(run):
    return phase_launches(run, "step.xupdate", "xupdate_launches_per_substep")
