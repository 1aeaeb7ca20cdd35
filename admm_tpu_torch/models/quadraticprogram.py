"""Quadratic program in two constraint forms (port of
``admm_tpu/models/quadraticprogram.py``; auto-detected like the reference,
solvers/quadraticprogram.m:259-364):

standard:   min 1/2 x^T P x + q^T x + r   s.t.  D x = s,  x >= 0
bounded:    min 1/2 x^T P x + q^T x + r   s.t.  lb <= x <= ub

Reference: solvers/quadraticprogram.m (wrapper; rho-keyed factor caches at
:188-219) and getProxOps.m case 'quadraticprogram' (:545-666) with proxes
xminQPStandard (getProxOps.m:1397-1412), xminQPBounded (:1441-1456) and
zminQPBounded (:1470-1474).

standard x-update:  KKT solve [P + rho I, D^T; D, 0][x;y] =
                    [rho (z - u) - q; s], keep x
standard z-update:  max(x + u, 0)
bounded  x-update:  (P + rho I)^{-1} (rho (z - u) - q)
bounded  z-update:  clip(x + u, lb, ub)   (user altproxg overrides,
                    getProxOps.m case :545-666)

Both re-factorization paths of the reference (it re-factors whenever rho
changes, getProxOps.m:1400-1405, 1444-1453) are replaced by a one-time
eigendecomposition of P; per-iteration work is GEMVs valid for any runtime
rho, plus, in the standard form under dynamic rho, an m-by-m Cholesky on
the device.
"""

from __future__ import annotations

from typing import Callable, Optional

import numpy as np
import torch

from ..config import ADMMConfig
from ..device import resolve_device
from ..engine import Hooks, admm
from ..ops.prox import project_box, project_nonneg
from ..ops.solve import SymShiftSolver
from ..results import ADMMResults
from . import register
from ._common import (as_tensor, bind_data, host64, host_dtype, merge_config, scaled_start,
                      timed_solver, unscale, warn_if_badly_scaled)
from .linearprogram import make_kkt_solver


def _prox_f_standard(x, z, u, rho, d):
    return d["kkt"].solve(rho * (z - u) - d["q"], d["s"], rho)


def _prox_g_standard(x, z, u, rho, d):
    return project_nonneg(x + u)


def _prox_f_bounded_static(x, z, u, rho, d):
    return d["Minv"] @ (rho * (z - u) - d["q"])


def _prox_f_bounded_adaptive(x, z, u, rho, d):
    return d["sol"].solve(rho * (z - u) - d["q"], rho)


def _prox_g_bounded(x, z, u, rho, d):
    return project_box(x + u, d["lb"], d["ub"])


def _obj(x, z, d):
    return 0.5 * torch.dot(x, d["P"] @ x) + torch.dot(d["q"], x) + d["r"]


def make_prox_ops_standard(
    P, q, D, s, config: ADMMConfig = ADMMConfig(),
    altproxg: Optional[Callable] = None, kkt_mode: str = "affine",
):
    """Standard (equality + nonnegativity) form (getProxOps.m:1397-1412),
    from tensors on the solve's device.  Static rho folds the whole KKT
    solve once at setup into the affine map x = K1 b1 + x0 (one GEMV per
    iteration); ``kkt_mode='chol'`` keeps the factored two-GEMV +
    triangular-pair apply.

    ``altproxg(x, z, u, rho, data) -> z`` replaces the nonnegativity
    projection (the reference's args.altproxg, getProxOps.m:664-666)."""
    data = {"q": q, "s": s, "kkt": make_kkt_solver(D, P, s, config, kkt_mode)}
    prox_g = altproxg if altproxg is not None else _prox_g_standard
    return _prox_f_standard, prox_g, data


def make_prox_ops_bounded(
    P, q, lb, ub, config: ADMMConfig = ADMMConfig(),
    altproxg: Optional[Callable] = None,
):
    """Bounded (box-constrained) form (getProxOps.m:1441-1474), from
    tensors on the solve's device."""
    data = {"q": q, "lb": lb, "ub": ub}
    if config.dynamic_rho:
        data["sol"] = SymShiftSolver.from_matrix(P)
        prox_f = _prox_f_bounded_adaptive
    else:
        data["Minv"] = SymShiftSolver.from_matrix(P).materialize_inverse(config.rho)
        prox_f = _prox_f_bounded_static
    prox_g = altproxg if altproxg is not None else _prox_g_bounded
    return prox_f, prox_g, data


def _placed(device, P, *vs):
    """P as a tensor on ``device`` and each of ``vs`` in P's dtype (None
    stays None)."""
    P = as_tensor(P).to(device)
    return (P, *(None if v is None else as_tensor(v).to(device=device, dtype=P.dtype)
                 for v in vs))


@register("quadraticprogram")
def _registry_entry(P, q, D=None, s=None, lb=None, ub=None, config=ADMMConfig(),
                    kkt_mode="affine", device=None, **_):
    device = resolve_device(device, P, q, D, s, lb, ub)
    P, q, D, s, lb, ub = _placed(device, P, q, D, s, lb, ub)
    if D is not None:
        pf, pg, data = make_prox_ops_standard(P, q, D, s, config, kkt_mode=kkt_mode)
    else:
        pf, pg, data = make_prox_ops_bounded(P, q, lb, ub, config)
    return bind_data(pf, pg, None, data)


def _check_constraints(cons1, cons2):
    """Both constraint operands are needed: ``admm_tpu`` lets a None
    through to fail late with a TypeError (``ADVICE.md``)."""
    for name, v in (("cons1", cons1), ("cons2", cons2)):
        if v is None:
            raise ValueError(
                f"quadraticprogram: {name} is None; pass (cons1, cons2) = (D, s) "
                "for the standard form or (lb, ub) for the bounded form")


@timed_solver
def quadraticprogram(
    P=None, q=None, r=None, cons1=None, cons2=None,
    config: ADMMConfig = ADMMConfig(), altproxg: Optional[Callable] = None,
    kkt_mode: str = "affine", *, precondition: bool = False,
    ruiz_iters: int = 15, x0=None, z0=None, u0=None, device=None, **overrides
) -> ADMMResults:
    """Solve a QP (reference solvers/quadraticprogram.m:99).

    Constraint-form auto-detection mirrors quadraticprogram.m:259-364:
    ``(cons1, cons2) = (D, s)`` with 2-D D selects the standard form;
    two vectors of length n select the bounded form (bounds are
    normalized so lb <= ub elementwise, quadraticprogram.m:340-350).
    ``altproxg`` replaces the z-prox in either form (getProxOps.m:664-666).
    ``kkt_mode`` ('affine' default / 'chol') applies to the standard form.
    Operands are numpy arrays or tensors; the solve runs in P's dtype on
    ``device``, or on the device of the first tensor among P, q, cons1,
    cons2, or on the CUDA device (``device.resolve_device``).  A None
    ``cons1`` or ``cons2`` raises ``ValueError`` up front.

    ``precondition=True`` Ruiz-equilibrates the KKT structure
    [[P, D^T], [D, 0]] (``ops/scaling.py``; bounded form: P alone, with
    the box bounds scaled along) and solves the equivalent scaled QP —
    identical optimum and objective value, far fewer iterations on
    badly scaled data.  xopt/zopt/uopt are unscaled back; residual
    traces and the Boyd stop act in the scaled space (OSQP convention);
    ``results.extra`` carries the scales; altproxg/warm starts then
    live in the scaled space (x~ = x / e).  Called with no
    arguments it runs its tester's demo instance (``testers.problems``).
    """
    if P is None:
        # Zero-arg demo mode (reference solvers, e.g. lasso.m:122-129).
        from ..testers.problems import quadraticprogramtest

        res, _test = quadraticprogramtest(quiet=False, device=device)
        return res
    _check_constraints(cons1, cons2)
    device = resolve_device(device, P, q, cons1, cons2)
    standard = np.ndim(cons1) == 2
    if precondition:
        from ..ops.scaling import ruiz_equilibrate

        dtype = host_dtype(P)
        P64, c1 = host64(P), host64(cons1)
        e, rr = ruiz_equilibrate(c1 if standard else None, P64, iters=ruiz_iters)
        Ps = ((e[:, None] * P64) * e[None, :]).astype(dtype)
        qs = (e * host64(q)).astype(dtype)
        if standard:
            c1s = ((rr[:, None] * c1) * e[None, :]).astype(dtype)
            c2s = (rr * host64(cons2)).astype(dtype)
        else:
            # Box bounds transform as x~ = x / e (e > 0 keeps order).
            c1s = (c1 / e).astype(dtype)
            c2s = (host64(cons2) / e).astype(dtype)
        res = quadraticprogram(Ps, qs, r, c1s, c2s, config, altproxg, kkt_mode, device=device,
                               **scaled_start(e, x0, z0, u0), **overrides)
        return unscale(res, e, rr if standard else None)
    if isinstance(P, np.ndarray):
        # Host-resident inputs only (the helper also size-caps).
        c1 = cons1 if isinstance(cons1, np.ndarray) and cons1.ndim == 2 else None
        warn_if_badly_scaled(c1 if c1 is not None else np.zeros((0, P.shape[0])), P)
    # affine KKT fold = one-GEMV body ('gemv'); chol mode's triangular
    # sweeps are 'heavy'.
    config = merge_config(config, overrides,
                          body="gemv" if kkt_mode == "affine" else "heavy")
    P, q, c1, c2 = _placed(device, P, q, cons1, cons2)
    n = P.shape[0]
    if standard:
        prox_f, prox_g, data = make_prox_ops_standard(
            P, q, c1, c2, config, altproxg=altproxg, kkt_mode=kkt_mode)
    else:
        lb, ub = torch.minimum(c1, c2), torch.maximum(c1, c2)
        prox_f, prox_g, data = make_prox_ops_bounded(P, q, lb, ub, config, altproxg=altproxg)
    data["P"] = P
    data["r"] = torch.as_tensor(r, dtype=P.dtype, device=device)
    return admm(
        prox_f, prox_g, config,
        A=1.0, B=-1.0, c=0.0, m=n, nA=n, nB=n,
        x0=x0, z0=z0, u0=u0,
        hooks=Hooks(obj=_obj), dtype=P.dtype, data=data, device=device,
    )
