"""Utilities of the port (``admm_tpu/utils`` counterparts): input
validation, the text report and plots, npz checkpoints, sharded
checkpoints under the orbax names (a format of the port's own), and
profiling."""

from .checkpoint import load_state, load_state_orbax, save_state, save_state_orbax
from .report import showresults
from .validate import errorcheck, slicemaker

__all__ = ["errorcheck", "slicemaker", "showresults", "save_state", "load_state",
           "save_state_orbax", "load_state_orbax"]
