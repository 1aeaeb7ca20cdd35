"""Huber fitting: min sum huber(D x - s), split as

    f(x) = 0,  g(z) = sum huber(z),   s.t.   D x - z = s

with huber(a) = a^2/2 for |a| <= 1, |a| - 1/2 otherwise (port of
``admm_tpu/models/huberfit.py``).

Reference: solvers/huberfit.m (wrapper, identical shape to lad.m; objective
huberfit.m:180) and getProxOps.m case 'huberfit' (:814-912) with z-prox
zminHuberSoftThresholding (getProxOps.m:1529-1539).

x-update:  same as LAD — solve D^T D x = D^T (s + z - u) (f == 0)
z-update:  z = (rho v + soft_threshold(v, 1 + 1/rho)) / (1 + rho),
           v = D x + u - s (or Axhat + u - s under relaxation)
"""

from __future__ import annotations

import torch

from ..config import ADMMConfig
from ..engine import Hooks, admm
from ..ops.prox import huber_prox
from ..results import ADMMResults
from . import register
from ._common import bind_data, merge_config, normal_equations_data, place_data, timed_solver


def huber_loss(a):
    """huber(a) = a^2/2 (|a| <= 1), |a| - 1/2 (else) — the penalty whose
    proximal operator is zminHuberSoftThresholding (getProxOps.m:1529-1539);
    equals 1/2 * the reference tester's huber() (huberfittest.m:131)."""
    aa = torch.abs(a)
    return torch.where(aa <= 1.0, 0.5 * a * a, aa - 0.5)


def _prox_f(x, z, u, rho, d):
    return d["Dplus"] @ (d["s"] + z - u)


def _prox_g(x, z, u, rho, d):
    return huber_prox(d["D"] @ x, u, d["s"], rho)


def _prox_g_relaxed(Axhat, z, u, rho, d):
    return huber_prox(Axhat, u, d["s"], rho)


def _obj(x, z, d):
    return torch.sum(huber_loss(z))


def make_prox_ops(D, s, config: ADMMConfig = ADMMConfig()):
    """Build (prox_f, prox_g, obj, data) for Huber fitting
    (getProxOps.m:814-912) from tensors on the solve's device."""
    data = normal_equations_data(D, s)
    prox_g = _prox_g if config.relax == 1.0 else _prox_g_relaxed
    return _prox_f, prox_g, _obj, data


@register("huberfit")
def _registry_entry(D, s, config=ADMMConfig(), device=None, **_):
    D, s, _device = place_data(D, s, device)
    return bind_data(*make_prox_ops(D, s, config))


@timed_solver
def huberfit(D=None, s=None, config: ADMMConfig = ADMMConfig(), *,
             x0=None, z0=None, u0=None, device=None, **overrides) -> ADMMResults:
    """Solve Huber fitting (reference solvers/huberfit.m:83).

    Constraint wiring: A = D, B = -1, c = s (same shape as lad.m:140-145).
    ``D``, ``s`` and ``device`` work as in ``lasso``.  The zero-argument
    demo mode (slice 11) is not ported yet and raises
    ``NotImplementedError``.
    """
    if D is None:
        raise NotImplementedError(
            "huberfit() demo mode needs the testers of ROADMAP.md queue 1, "
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
