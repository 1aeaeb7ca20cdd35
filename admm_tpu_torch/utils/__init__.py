"""Utilities of the port (``admm_tpu/utils`` counterparts): input
validation so far; reporting, checkpoints and profiling come with slice 11
of ROADMAP.md queue 1."""

from .validate import errorcheck, slicemaker

__all__ = ["errorcheck", "slicemaker"]
