"""Problem families of the port (``admm_tpu/models`` counterparts).  Only
the serial LASSO is ported so far; the string registry comes with slice 3
of ROADMAP.md queue 1."""

from .lasso import lasso

__all__ = ["lasso"]
