"""The model problem: min 1/2||Px - r||^2 + 1/2||Qx - s||^2 via ADMM
splitting f(x) = 1/2||Px - r||^2, g(z) = 1/2||Qz - s||^2, x - z = 0 (port
of ``admm_tpu/models/model.py``).

Reference: solvers/model.m (wrapper, precompute at model.m:119-138) and
getProxOps.m case 'model' (:55-95) with proxes xminModel (:952-975) /
zminModel (:989-1012):

    x <- (P^T P + rho I)^{-1} (P^T r + rho (z - u))
    z <- (Q^T Q + rho I)^{-1} (Q^T s + rho (x + u))

Static rho materializes both inverses (one GEMV per prox); adaptive rho
keeps the eigendecompositions (``ops/solve.SymShiftSolver``).
"""

from __future__ import annotations

import torch

from ..config import ADMMConfig
from ..device import resolve_device
from ..engine import Hooks, admm
from ..ops.solve import SymShiftSolver
from ..results import ADMMResults
from . import register
from ._common import as_tensor, bind_data, merge_config, timed_solver


def _prox_f_static(x, z, u, rho, d):
    return d["PtPinv"] @ (d["Ptr"] + rho * (z - u))


def _prox_g_static(x, z, u, rho, d):
    return d["QtQinv"] @ (d["Qts"] + rho * (x + u))


def _prox_f_adaptive(x, z, u, rho, d):
    return d["solP"].solve(d["Ptr"] + rho * (z - u), rho)


def _prox_g_adaptive(x, z, u, rho, d):
    return d["solQ"].solve(d["Qts"] + rho * (x + u), rho)


def _obj(x, z, d):
    return 0.5 * torch.sum((d["P"] @ x - d["r"]) ** 2) + 0.5 * torch.sum(
        (d["Q"] @ z - d["s"]) ** 2
    )


def make_prox_ops(P, Q, r, s, config: ADMMConfig = ADMMConfig()):
    """Build (prox_f, prox_g, obj, data) for the model problem from
    tensors on the solve's device."""
    data = {"P": P, "Q": Q, "r": r, "s": s, "Ptr": P.T @ r, "Qts": Q.T @ s}

    if config.dynamic_rho:
        data["solP"] = SymShiftSolver.from_matrix(P.T @ P)
        data["solQ"] = SymShiftSolver.from_matrix(Q.T @ Q)
        return _prox_f_adaptive, _prox_g_adaptive, _obj, data

    rho0 = config.rho
    data["PtPinv"] = SymShiftSolver.from_matrix(P.T @ P).materialize_inverse(rho0)
    data["QtQinv"] = SymShiftSolver.from_matrix(Q.T @ Q).materialize_inverse(rho0)
    return _prox_f_static, _prox_g_static, _obj, data


def _place(P, Q, r, s, device):
    """P, Q, r and s on the solve's device (``device.resolve_device``) in
    P's dtype."""
    device = resolve_device(device, P, Q, r, s)
    P = as_tensor(P).to(device)
    return (P, *(as_tensor(a).to(device=device, dtype=P.dtype) for a in (Q, r, s))), device


@register("model")
def _registry_entry(P, Q, r, s, config=ADMMConfig(), device=None, **_):
    operands, _device = _place(P, Q, r, s, device)
    return bind_data(*make_prox_ops(*operands, config))


@timed_solver
def model(P=None, Q=None, r=None, s=None, config: ADMMConfig = ADMMConfig(), *,
          x0=None, z0=None, u0=None, device=None, **overrides) -> ADMMResults:
    """Solve the model problem (reference solvers/model.m:47).

    Constraint wiring matches model.m:129-134: A = 1, B = -1, c = 0 in R^n.
    P, Q, r and s are numpy arrays or tensors; the solve runs in P's dtype
    on ``device``, or on P's device when P is a tensor, or on the CUDA
    device (``device.resolve_device``).  Called with no
    arguments it runs its tester's demo instance (``testers.problems``).
    """
    if P is None:
        # Zero-arg demo mode (reference solvers, e.g. lasso.m:122-129).
        from ..testers.problems import modeltest

        res, _test = modeltest(quiet=False, device=device)
        return res
    config = merge_config(config, overrides, body="gemv")
    (P, Q, r, s), device = _place(P, Q, r, s, device)
    n = P.shape[1]
    prox_f, prox_g, obj, data = make_prox_ops(P, Q, r, s, config)
    return admm(
        prox_f, prox_g, config,
        A=1.0, B=-1.0, c=0.0, m=n, nA=n, nB=n,
        x0=x0, z0=z0, u0=u0,
        hooks=Hooks(obj=obj), dtype=P.dtype, data=data, device=device,
    )
