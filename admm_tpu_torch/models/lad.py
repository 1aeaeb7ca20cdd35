"""Least absolute deviations: min ||D x - s||_1, split as

    f(x) = 0,  g(z) = ||z||_1,   s.t.   D x - z = s

(port of ``admm_tpu/models/lad.py``).

Reference: solvers/lad.m (wrapper; R = chol(D^T D) at lad.m:134, constraint
A = D, B = -1, c = s at lad.m:140-145) and getProxOps.m case 'lad'
(:753-811) with x-prox xminLAD (getProxOps.m:1511-1515).

x-update:  solve D^T D x = D^T (s + z - u)
z-update:  soft_threshold(D x + u - s, 1/rho)
           (relaxation-aware variant consumes Axhat directly, selected by
           config.relax — the reference's args.userelax, lad.m:124-126)

The x-update is rho-independent, so the normal-equations pseudo-inverse
(D^T D)^{-1} D^T is materialized once at setup; every x-update then is
one m->n GEMV instead of the reference's pair of triangular solves.
"""

from __future__ import annotations

import torch

from ..config import ADMMConfig
from ..engine import Hooks, admm
from ..ops.prox import soft_threshold
from ..results import ADMMResults
from . import register
from ._common import bind_data, merge_config, normal_equations_data, place_data, timed_solver


def _prox_f(x, z, u, rho, d):
    return d["Dplus"] @ (d["s"] + z - u)


def _prox_g(x, z, u, rho, d):
    return soft_threshold(d["D"] @ x + u - d["s"], 1.0 / rho)


def _prox_g_relaxed(Axhat, z, u, rho, d):
    # Relaxed path: the engine hands Axhat as the first argument
    # (reference relaxation-aware z-prox, getProxOps.m case :753-811).
    return soft_threshold(Axhat + u - d["s"], 1.0 / rho)


def _obj(x, z, d):
    return torch.sum(torch.abs(z))


def make_prox_ops(D, s, config: ADMMConfig = ADMMConfig()):
    """Build (prox_f, prox_g, obj, data) for LAD (getProxOps.m:753-811)
    from tensors on the solve's device."""
    data = normal_equations_data(D, s)
    prox_g = _prox_g if config.relax == 1.0 else _prox_g_relaxed
    return _prox_f, prox_g, _obj, data


@register("lad")
def _registry_entry(D, s, config=ADMMConfig(), device=None, **_):
    D, s, _device = place_data(D, s, device)
    return bind_data(*make_prox_ops(D, s, config))


@timed_solver
def lad(D=None, s=None, config: ADMMConfig = ADMMConfig(), *,
        x0=None, z0=None, u0=None, device=None, **overrides) -> ADMMResults:
    """Solve least absolute deviations (reference solvers/lad.m:51).

    Constraint wiring matches lad.m:140-145: A = D, B = -1, c = s.
    ``D``, ``s`` and ``device`` work as in ``lasso``.  The zero-argument
    demo mode (slice 11) is not ported yet and raises
    ``NotImplementedError``.
    """
    if D is None:
        raise NotImplementedError(
            "lad() demo mode needs the testers of ROADMAP.md queue 1, "
            "slice 11, which are not ported yet")
    config = merge_config(config, overrides, body="gemv")
    D, s, device = place_data(D, s, device)
    prox_f, prox_g, obj, data = make_prox_ops(D, s, config)
    m, n = D.shape
    return admm(
        prox_f, prox_g, config,
        A=D, B=-1.0, c=s, m=m, nA=n, nB=m,
        x0=x0, z0=z0, u0=u0,
        hooks=Hooks(obj=obj), dtype=D.dtype, data=data, device=device,
    )
