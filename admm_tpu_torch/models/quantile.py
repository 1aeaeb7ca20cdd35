"""Quantile regression: min sum_i pinball_tau((D x - s)_i), split as

    f(x) = 0,  g(z) = sum_i pinball_tau(z_i),   s.t.   D x - z = s,

with the pinball (check) loss pinball_tau(r) = tau*max(r,0) +
(1-tau)*max(-r,0) (port of ``admm_tpu/models/quantile.py``).  tau = 0.5
is least absolute deviations up to a 0.5 objective scale (same minimizer;
models/lad.py is the symmetric special case, reference
getProxOps.m:753-811); other tau estimate the conditional tau-quantile.

Beyond the reference (its robust-regression family stops at LAD and
Huber).  The structure is LAD's exactly: the x-update is the shared
rho-independent normal-equations GEMV ((D^T D)^{-1} D^T materialized
once, _common.normal_equations_data), and the z-update is the pinball
prox, an asymmetric soft threshold at (tau/rho, (1-tau)/rho)
(ops/prox.asymmetric_soft_threshold).

Oracle: quantile regression is an LP (minimize tau*1'p + (1-tau)*1'q
s.t. Dx - s = p - q, p,q >= 0), so the tests check the ADMM objective
against scipy.optimize.linprog on the exact same instance.
"""

from __future__ import annotations

import torch

from ..config import ADMMConfig
from ..engine import Hooks, admm
from ..ops.prox import asymmetric_soft_threshold
from ..results import ADMMResults
from . import register
from ._common import bind_data, merge_config, normal_equations_data, place_data, timed_solver


def _prox_f(x, z, u, rho, d):
    return d["Dplus"] @ (d["s"] + z - u)


def _prox_g(x, z, u, rho, d):
    v = d["D"] @ x + u - d["s"]
    return asymmetric_soft_threshold(v, d["tau"] / rho, (1.0 - d["tau"]) / rho)


def _prox_g_relaxed(Axhat, z, u, rho, d):
    # Relaxed path: the engine hands Axhat as the first argument
    # (the LAD/huber relaxation-aware convention, getProxOps.m:753-912).
    v = Axhat + u - d["s"]
    return asymmetric_soft_threshold(v, d["tau"] / rho, (1.0 - d["tau"]) / rho)


def _obj(x, z, d):
    return torch.sum(torch.maximum(d["tau"] * z, (d["tau"] - 1.0) * z))


def make_prox_ops(D, s, tau=0.5, config: ADMMConfig = ADMMConfig()):
    """Build (prox_f, prox_g, obj, data) for quantile regression from
    tensors on the solve's device.

    ``tau`` rides in ``data`` as a 0-d tensor on that device, so the
    z-prox's thresholds are device arithmetic with rho."""
    if not 0.0 < float(tau) < 1.0:
        raise ValueError(f"tau must be in (0, 1), got {tau}")
    data = normal_equations_data(D, s)
    data["tau"] = torch.as_tensor(tau, dtype=D.dtype, device=D.device)
    prox_g = _prox_g if config.relax == 1.0 else _prox_g_relaxed
    return _prox_f, prox_g, _obj, data


@register("quantile")
def _registry_entry(D, s, tau=0.5, config=ADMMConfig(), device=None, **_):
    D, s, _device = place_data(D, s, device)
    return bind_data(*make_prox_ops(D, s, tau, config))


@timed_solver
def quantile(D, s, tau=0.5, config: ADMMConfig = ADMMConfig(), *,
             x0=None, z0=None, u0=None, device=None, **overrides) -> ADMMResults:
    """Solve quantile regression at level ``tau``.

    Constraint wiring matches LAD (lad.m:140-145): A = D, B = -1, c = s.
    ``D``, ``s`` and ``device`` work as in ``lasso``.
    """
    config = merge_config(config, overrides, body="gemv")
    D, s, device = place_data(D, s, device)
    prox_f, prox_g, obj, data = make_prox_ops(D, s, tau, config)
    m, n = D.shape
    return admm(
        prox_f, prox_g, config,
        A=D, B=-1.0, c=s, m=m, nA=n, nB=m,
        x0=x0, z0=z0, u0=u0,
        hooks=Hooks(obj=obj), dtype=D.dtype, data=data, device=device,
    )
