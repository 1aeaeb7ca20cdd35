"""admm_tpu_torch — the PyTorch/CUDA port of ``admm_tpu``.

A second package beside ``admm_tpu``, which stays the reference.  Module
names mirror ``admm_tpu``'s so each counterpart is easy to find.  The port
imports ``torch`` and never ``jax``.

Ported so far (ROADMAP.md, queue 1, slice 1): the alg-0 engine, the serial
LASSO with all four x-prox branches, and the fused soft-threshold /
dual-update pass as a Triton kernel for Hopper GPUs.
"""

from .config import ADMMConfig
from .engine import Hooks, admm
from .models import lasso
from .results import ADMMResults

__all__ = ["ADMMConfig", "ADMMResults", "Hooks", "admm", "lasso"]
