"""Problem families of the port (``admm_tpu/models`` counterparts): the
serial LASSO and 1-D and 2-D total variation so far; the string registry
comes with slice 3 of ROADMAP.md queue 1."""

from .lasso import lasso
from .totalvariation import totalvariation
from .totalvariation2d import totalvariation2d

__all__ = ["lasso", "totalvariation", "totalvariation2d"]
