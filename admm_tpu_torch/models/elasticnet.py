"""Elastic net: min 1/2 ||D x - s||^2 + lam (alpha ||z||_1 +
(1 - alpha)/2 ||z||^2)  s.t.  x - z = 0  (port of
``admm_tpu/models/elasticnet.py``).

Beyond the reference (its shrinkage family is lasso/basis-pursuit/TV —
getProxOps.m:313-456 — with no combined l1+l2 penalty); standard ADMM
formulation per Boyd et al. §6.  The x-update is the shared least-squares
prox (``lasso.make_ls_xprox``), so elastic net takes every lasso x-update
path, the bf16 streams of the fat static-rho branch included.  The
z-update composes shrinkage with a uniform rescale:

    z = soft_threshold(x + u, lam*alpha/rho) / (1 + lam*(1-alpha)/rho)

``alpha=1`` recovers lasso exactly; ``alpha=0`` is ridge regression.

Not ported yet: ``elasticnet_batch`` (slice 8 of ROADMAP.md queue 1).
"""

from __future__ import annotations

import torch

from ..config import ADMMConfig
from ..engine import Hooks, admm
from ..ops.prox import soft_threshold
from ..results import ADMMResults
from . import register
from ._common import bind_data, check_data_vector, merge_config, place_data, timed_solver
from .lasso import make_ls_xprox


def _prox_g(x, z, u, rho, d):
    v = x + u
    l1 = d["lam"] * d["alpha"]
    l2 = d["lam"] * (1.0 - d["alpha"])
    return soft_threshold(v, l1 / rho) / (1.0 + l2 / rho)


def _obj(x, z, d):
    fit = 0.5 * torch.sum((d["D"] @ x - d["s"]) ** 2)
    pen = d["lam"] * (d["alpha"] * torch.sum(torch.abs(z))
                      + 0.5 * (1.0 - d["alpha"]) * torch.sum(z**2))
    return fit + pen


def make_prox_ops(D, s, lam, alpha=0.5, config: ADMMConfig = ADMMConfig(),
                  stream_dtype=None):
    """Build (prox_f, prox_g, obj, data) for the elastic net; ``D`` and
    ``s`` are tensors on the solve's device."""
    if not 0.0 <= float(alpha) <= 1.0:
        raise ValueError(f"alpha must be in [0, 1], got {alpha}")
    prox_f, data = make_ls_xprox(D, s, config, stream_dtype)
    data["lam"] = torch.as_tensor(lam, dtype=D.dtype, device=D.device)
    data["alpha"] = torch.as_tensor(alpha, dtype=D.dtype, device=D.device)
    return prox_f, _prox_g, _obj, data


@register("elasticnet")
def _registry_entry(D, s, lam, alpha=0.5, config=ADMMConfig(), device=None, **_):
    D, s, _device = place_data(D, s, device)
    return bind_data(*make_prox_ops(D, s, lam, alpha, config))


@timed_solver
def elasticnet(D, s, lam, alpha=0.5, config: ADMMConfig = ADMMConfig(), *,
               stream_dtype=None, x0=None, z0=None, u0=None, device=None,
               **overrides) -> ADMMResults:
    """Solve the elastic net.  ``alpha`` blends l1 (alpha=1, pure lasso)
    and squared-l2 (alpha=0, ridge) regularization at total strength
    ``lam``.  Constraint wiring x - z = 0 as in lasso (lasso.m:226-239).
    ``stream_dtype``, ``device`` and the warm start work as in ``lasso``.
    """
    check_data_vector(D, s)
    config = merge_config(config, overrides, body="gemv")
    D, s, device = place_data(D, s, device)
    n = D.shape[1]
    prox_f, prox_g, obj, data = make_prox_ops(D, s, lam, alpha, config,
                                              stream_dtype)
    return admm(
        prox_f, prox_g, config,
        A=1.0, B=-1.0, c=0.0, m=n, nA=n, nB=n,
        x0=x0, z0=z0, u0=u0,
        hooks=Hooks(obj=obj), dtype=D.dtype, data=data, device=device,
    )
