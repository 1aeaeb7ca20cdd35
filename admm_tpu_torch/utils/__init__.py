"""Utilities of the port (``admm_tpu/utils`` counterparts): input
validation, the text report and plots, npz checkpoints, and profiling.
The orbax checkpoints of sharded state wait for slice 10b of ROADMAP.md
queue 1 and raise."""

from .checkpoint import load_state, load_state_orbax, save_state, save_state_orbax
from .report import showresults
from .validate import errorcheck, slicemaker

__all__ = ["errorcheck", "slicemaker", "showresults", "save_state", "load_state",
           "save_state_orbax", "load_state_orbax"]
