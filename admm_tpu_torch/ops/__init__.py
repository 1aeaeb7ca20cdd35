"""Operator building blocks: proxes, linear solves and GPU kernels.

Re-exports the 14 names of ``admm_tpu/ops/__init__.py``.  The kernels'
wrappers (``ops/kernels.py``, ``ops/gemv_pair.py``, ``ops/tridiag.py``)
import here too, but build and load the CUDA library only at their first
launch (``ops/_cuda.py``).
"""

from .matfun import covsel_ns_prox, ns_sqrtm
from .prox import (covsel_eig_prox, hinge_prox, huber_prox, project_box, project_nonneg,
                   soft_threshold, zero_one_prox)
from .scaling import kkt_scale_quality, ruiz_equilibrate
from .solve import SymShiftSolver, WoodburySolver, kkt_eq_solver

__all__ = [
    "soft_threshold",
    "hinge_prox",
    "zero_one_prox",
    "huber_prox",
    "project_nonneg",
    "project_box",
    "ruiz_equilibrate",
    "kkt_scale_quality",
    "covsel_eig_prox",
    "SymShiftSolver",
    "WoodburySolver",
    "kkt_eq_solver",
    "ns_sqrtm",
    "covsel_ns_prox",
]
