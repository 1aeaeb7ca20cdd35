"""admm_tpu_torch — the PyTorch/CUDA port of ``admm_tpu``.

A second package beside ``admm_tpu``, which stays the reference.  Module
names mirror ``admm_tpu``'s so each counterpart is easy to find.  The port
imports ``torch`` and never ``jax``.

Ported so far (ROADMAP.md, queue 1, slices 1 to 6 and the spectral half
of 7):
the engine with all of its serial variants (fast and accelerated ADMM,
H-norm stops, adaptive and residual-balancing rho, the stall detector,
Anderson acceleration, iterate records and every hook) and ``FnOp``; the
model problem; the serial LASSO with all four x-prox branches and the fused
soft-threshold / dual-update pass, alone or with the whole step tail, as a
CUDA C++ kernel for Hopper GPUs;
elastic net, NNLS and group lasso on the same x-update; the bf16-stream
x-update of all four, whose GEMV pair is a CUDA C++ kernel for Hopper;
1-D total variation with its dense and cyclic-reduction x-updates, the
cyclic-reduction solve as a CUDA C++ kernel for Hopper; 2-D total
variation; basis pursuit and the fused lasso (``StackIDiffOp``); LAD,
Huber fitting and quantile regression on one normal-equations x-update;
the linear SVM (hinge and 0-1 loss) through the serial unwrapped-ADMM
solver; the standard-form LP and the QP in both constraint forms on the
Schur-complement KKT solvers, with Ruiz preconditioning; covariance
selection and the standard-form SDP on matrix iterates, with eigh or
Newton-Schulz spectral proxes; and the string registry ``get_prox_ops``
with its ``errorcheck`` (``utils/validate.py``).  ``admm_tpu_torch.experiments`` holds the two
probes of ``experiments/`` whose TPU kernels run the GEMV pair and the
whole fat-LASSO iteration in one launch.
"""

from .config import ADMMConfig
from .engine import Hooks, admm
from .linop import FnOp
from .models import (basispursuit, covarianceselection, elasticnet, fusedlasso, get_prox_ops,
                     grouplasso, huberfit, lad, lasso, linearprogram, linearsvm, model, nnls,
                     quadraticprogram, quantile, sdp, totalvariation, totalvariation2d,
                     unwrappedadmm)
from .results import ADMMResults

__all__ = ["ADMMConfig", "ADMMResults", "FnOp", "Hooks", "admm", "basispursuit",
           "covarianceselection", "elasticnet", "fusedlasso", "get_prox_ops", "grouplasso",
           "huberfit", "lad", "lasso", "linearprogram", "linearsvm", "model", "nnls",
           "quadraticprogram", "quantile", "sdp", "totalvariation", "totalvariation2d",
           "unwrappedadmm"]
