"""Nonnegative least squares: min 1/2 ||D x - s||^2  s.t.  x >= 0  (port
of ``admm_tpu/models/nnls.py``).

Beyond the reference (its constrained family is LP/QP/box,
solvers/linearprogram.m, quadraticprogram.m; it has no dedicated NNLS
entry).  ADMM splitting: f = the least-squares term, g = the indicator of
the nonnegative orthant, x - z = 0 — so the x-update is the shared
least-squares prox (``lasso.make_ls_xprox``) and the z-update is the
projection ``ops/prox.project_nonneg``.  z is the feasible iterate; the
objective is reported at z.

Not ported yet: ``nnls_batch`` (slice 8 of ROADMAP.md queue 1).
"""

from __future__ import annotations

import torch

from ..config import ADMMConfig
from ..engine import Hooks, admm
from ..ops.prox import project_nonneg
from ..results import ADMMResults
from . import register
from ._common import bind_data, check_data_vector, merge_config, place_data, timed_solver
from .lasso import make_ls_xprox


def _prox_g(x, z, u, rho, d):
    return project_nonneg(x + u)


def _obj(x, z, d):
    # z is the projected (feasible) iterate.
    return 0.5 * torch.sum((d["D"] @ z - d["s"]) ** 2)


def make_prox_ops(D, s, config: ADMMConfig = ADMMConfig(), stream_dtype=None):
    """Build (prox_f, prox_g, obj, data) for NNLS; ``D`` and ``s`` are
    tensors on the solve's device."""
    prox_f, data = make_ls_xprox(D, s, config, stream_dtype)
    return prox_f, _prox_g, _obj, data


@register("nnls")
def _registry_entry(D, s, config=ADMMConfig(), device=None, **_):
    D, s, _device = place_data(D, s, device)
    return bind_data(*make_prox_ops(D, s, config))


@timed_solver
def nnls(D, s, config: ADMMConfig = ADMMConfig(), *, stream_dtype=None,
         x0=None, z0=None, u0=None, device=None, **overrides) -> ADMMResults:
    """Solve nonnegative least squares; ``results.zopt`` is the feasible
    (projected) solution.  ``stream_dtype``, ``device`` and the warm start
    work as in ``lasso``."""
    check_data_vector(D, s)
    config = merge_config(config, overrides, body="gemv")
    D, s, device = place_data(D, s, device)
    n = D.shape[1]
    prox_f, prox_g, obj, data = make_prox_ops(D, s, config, stream_dtype)
    return admm(
        prox_f, prox_g, config,
        A=1.0, B=-1.0, c=0.0, m=n, nA=n, nB=n,
        x0=x0, z0=z0, u0=u0,
        hooks=Hooks(obj=obj), dtype=D.dtype, data=data, device=device,
    )
