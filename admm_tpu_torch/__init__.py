"""admm_tpu_torch — the PyTorch/CUDA port of ``admm_tpu``.

A second package beside ``admm_tpu``, which stays the reference.  Module
names mirror ``admm_tpu``'s so each counterpart is easy to find.  The port
imports ``torch`` and never ``jax``.

Ported so far (ROADMAP.md, queue 1, slices 1 to 8):
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
Newton-Schulz spectral proxes; robust PCA and matrix completion with
exact or randomized SVT, and sparse logistic regression with dense or
matrix-free Newton x-proxes; the functional runner ``make_admm_runner``
and its lanes (B instances in one solve, ``torch.func.vmap`` over the
step), the instance batches ``*_batch`` of every family and the
regularization paths ``*_path``, the TV lanes' cyclic-reduction solves
one launch of the kernel a sub-step; and the string registry ``get_prox_ops``
with its ``errorcheck`` (``utils/validate.py``).  ``admm_tpu_torch.experiments`` holds the two
probes of ``experiments/`` whose TPU kernels run the GEMV pair and the
whole fat-LASSO iteration in one launch.
"""

from .config import ADMMConfig
from .engine import Hooks, admm, make_admm_runner
from .linop import FnOp
from .models import (basispursuit, covarianceselection, elasticnet, fusedlasso, get_prox_ops,
                     grouplasso, huberfit, lad, lasso, linearprogram, linearsvm, logreg,
                     matrixcompletion, model, nnls, quadraticprogram, quantile, rpca, sdp,
                     totalvariation, totalvariation2d, unwrappedadmm)
from .models.batch import (BatchResults, QPStructure, basispursuit_batch, covsel_batch,
                           elasticnet_batch, fusedlasso_batch, grouplasso_batch, huberfit_batch,
                           lad_batch, lasso_batch, logreg_batch, lp_batch,
                           matrixcompletion_batch, model_batch, nnls_batch, qp_batch,
                           qp_structure, quantile_batch, rpca_batch, sdp_batch, svm_batch,
                           tv2d_batch, tv_batch)
from .models.paths import PathResults, covsel_path, lasso_path, linearsvm_c_path, tv_path
from .results import ADMMResults

__all__ = ["ADMMConfig", "ADMMResults", "BatchResults", "FnOp", "Hooks", "PathResults",
           "QPStructure", "admm", "basispursuit", "basispursuit_batch", "covarianceselection",
           "covsel_batch", "covsel_path", "elasticnet", "elasticnet_batch", "fusedlasso",
           "fusedlasso_batch", "get_prox_ops", "grouplasso", "grouplasso_batch", "huberfit",
           "huberfit_batch", "lad", "lad_batch", "lasso", "lasso_batch", "lasso_path",
           "linearprogram", "linearsvm", "linearsvm_c_path", "logreg", "logreg_batch",
           "lp_batch", "make_admm_runner", "matrixcompletion", "matrixcompletion_batch",
           "model", "model_batch", "nnls", "nnls_batch", "qp_batch", "qp_structure",
           "quadraticprogram", "quantile", "quantile_batch", "rpca", "rpca_batch", "sdp",
           "sdp_batch", "svm_batch", "totalvariation", "totalvariation2d", "tv2d_batch",
           "tv_batch", "tv_path", "unwrappedadmm"]
