"""Problem families of the port (``admm_tpu/models`` counterparts): the
serial LASSO, elastic net, NNLS and group lasso, the model problem, and
1-D and 2-D total variation so far; the string registry comes with slice 3 of ROADMAP.md
queue 1."""

from .elasticnet import elasticnet
from .grouplasso import grouplasso
from .lasso import lasso
from .model import model
from .nnls import nnls
from .totalvariation import totalvariation
from .totalvariation2d import totalvariation2d

__all__ = ["elasticnet", "grouplasso", "lasso", "model", "nnls", "totalvariation",
           "totalvariation2d"]
