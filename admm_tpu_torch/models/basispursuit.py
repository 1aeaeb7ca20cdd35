"""Basis pursuit: min ||z||_1  s.t.  D x = s,  x - z = 0 (port of
``admm_tpu/models/basispursuit.py``).

Reference: solvers/basispursuit.m (wrapper; projection precompute at
basispursuit.m:116-120) and getProxOps.m case 'basispursuit' (:98-142)
with x-prox xminBasisPursuit (getProxOps.m:1027-1032).

x-update:  projection onto {x : D x = s}:
           x = P (z - u) + q,   P = I - D^T (D D^T)^{-1} D,
                                q = D^T (D D^T)^{-1} s
z-update:  soft_threshold(u + x, 1/rho)

Requires an underdetermined (fat) D: the reference rejects square or
overdetermined systems (basispursuit.m:192-203).  P and q are built once
at setup through a Cholesky factorization of the m-by-m Gram, after which
every x-update is one n-by-n GEMV.
"""

from __future__ import annotations

import torch

from ..config import ADMMConfig
from ..engine import Hooks, admm
from ..ops.prox import soft_threshold
from ..results import ADMMResults
from . import register
from ._common import bind_data, check_data_vector, merge_config, place_data, timed_solver


def _prox_f(x, z, u, rho, d):
    return d["P"] @ (z - u) + d["q"]


def _prox_g(x, z, u, rho, d):
    return soft_threshold(u + x, 1.0 / rho)


def _obj(x, z, d):
    return torch.sum(torch.abs(z))


def make_prox_ops(D, s, config: ADMMConfig = ADMMConfig()):
    """Build (prox_f, prox_g, obj, data) for basis pursuit
    (getProxOps.m:98-142) from tensors on the solve's device."""
    m, n = D.shape
    if m >= n:
        raise ValueError(
            "basis pursuit requires an underdetermined system (m < n); "
            f"got D of shape {(m, n)} (reference basispursuit.m:192-203)"
        )

    G = D @ D.T
    L = torch.linalg.cholesky(0.5 * (G + G.T))
    # P = I - D^T (D D^T)^{-1} D, q = D^T (D D^T)^{-1} s  (basispursuit.m:116-120)
    P = torch.eye(n, dtype=D.dtype, device=D.device) - D.T @ torch.cholesky_solve(D, L)
    q = D.T @ torch.cholesky_solve(s[:, None], L)[:, 0]
    return _prox_f, _prox_g, _obj, {"P": P, "q": q}


@register("basispursuit")
def _registry_entry(D, s, config=ADMMConfig(), device=None, **_):
    D, s, _device = place_data(D, s, device)
    return bind_data(*make_prox_ops(D, s, config))


@timed_solver
def basispursuit(D=None, s=None, config: ADMMConfig = ADMMConfig(), *,
                 x0=None, z0=None, u0=None, device=None, **overrides) -> ADMMResults:
    """Solve basis pursuit (reference solvers/basispursuit.m:52).

    Constraint wiring: A = 1, B = -1, c = 0 in R^n.  ``D`` and ``s`` are
    numpy arrays or tensors; the solve runs in D's dtype on ``device``, or
    on D's device when D is a tensor, or on the CUDA device
    (``device.resolve_device``).  The zero-argument demo mode (slice 11)
    is not ported yet and raises ``NotImplementedError``.
    """
    if D is None:
        raise NotImplementedError(
            "basispursuit() demo mode needs the testers of ROADMAP.md queue 1, "
            "slice 11, which are not ported yet")
    check_data_vector(D, s)
    config = merge_config(config, overrides, body="gemv")
    D, s, device = place_data(D, s, device)
    n = D.shape[1]
    prox_f, prox_g, obj, data = make_prox_ops(D, s, config)
    return admm(
        prox_f, prox_g, config,
        A=1.0, B=-1.0, c=0.0, m=n, nA=n, nB=n,
        x0=x0, z0=z0, u0=u0,
        hooks=Hooks(obj=obj), dtype=D.dtype, data=data, device=device,
    )
