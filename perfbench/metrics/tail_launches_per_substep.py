"""Host launch calls of the sub-step's tail, everything after the
x-update (K1b's one launch on the fused LASSO; relaxation, z-update,
dual, norms, errors, stop, history and the freeze select on the generic
step): the launch calls starting inside the ``step.tail`` spans over the
``step`` spans.  The note gives the tail's launches, host time and device
time per sub-step, as ``xupdate_launches_per_substep``'s does."""

from benchlib.spans import phase_launches

UNIT = "launches/substep"
BETTER = "lower"
SOURCE = "program_span"
LAYER = "engine: step tail"
MOVES = "iter_per_s"
WORKLOADS = ["lasso_boyd_1500x5000.solve", "tv1d_65536.solve", "lasso_boyd_1500x5000.path100"]


def read(run):
    return phase_launches(run, "step.tail", "tail_launches_per_substep")
