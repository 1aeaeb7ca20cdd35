"""Fused lasso signal approximator (port of
``admm_tpu/models/fusedlasso.py``):

    min_x  1/2 ||x - s||^2 + lam1 ||x||_1 + lam2 ||D x||_1

Simultaneous sparsity and piecewise-constancy (Tibshirani et al. 2005),
the l1-trend-filtering cousin of the library's TV denoiser.  Beyond the
reference (its shrinkage family penalizes one transform at a time); the
ADMM splitting stacks both:

    z = [z1; z2],  A = [I; D],  B = -I,  c = 0,
    x-step:  (I + rho (I + D^T D))^{-1} (s + rho A^T (z - u))
             — the rho-shifted solve is eig-folded once at setup, one
             n-by-n GEMV per iteration
    z-step:  soft-threshold with a per-row threshold vector
             [lam1/rho ... ; lam2/rho ...]

Degenerate cases give exact oracles: lam2 = 0 reduces to elementwise
soft-thresholding of s (closed form), lam1 = 0 reduces to the TV
denoiser (same D convention, models/totalvariation.py).
"""

from __future__ import annotations

import torch

from ..config import ADMMConfig
from ..device import resolve_device
from ..engine import Hooks, admm
from ..linop import DiffOp, StackIDiffOp
from ..ops.prox import soft_threshold
from ..results import ADMMResults
from . import register
from ._common import as_tensor, bind_data, merge_config, timed_solver


def _prox_f(x, z, u, rho, d):
    return d["Minv"] @ (d["s"] + rho * d["A"].rmv(z - u))


def _prox_f_adaptive(x, z, u, rho, d):
    # rho-parameterized eigenbasis solve (dynamic rho): M = I + rho(I+DtD).
    y = d["V"].T @ (d["s"] + rho * d["A"].rmv(z - u))
    return d["V"] @ (y / (1.0 + rho * (1.0 + d["w"])))


def _prox_g(x, z, u, rho, d):
    # The engine hands the raw x; apply A = [I; D] here (the TV z-prox
    # convention, getProxOps.m:1044-1048), matrix-free.
    return soft_threshold(d["A"].mv(x) + u, d["t"] / rho)


def _prox_g_relaxed(Axhat, z, u, rho, d):
    # Relaxed path: the engine hands Axhat (already in the stacked 2n
    # space) as the first argument.
    return soft_threshold(Axhat + u, d["t"] / rho)


def _obj(x, z, d):
    # Evaluated at the split point z = [x; Dx] (exact at convergence).
    return 0.5 * torch.sum((x - d["s"]) ** 2) + torch.sum(d["t"] * torch.abs(z))


def make_prox_ops(s, lam1, lam2, config: ADMMConfig = ADMMConfig()):
    """Build (prox_f, prox_g, obj, data, A) for the fused lasso from a 1-D
    tensor ``s`` on the solve's device.

    lam1/lam2 ride in ``data`` as the stacked per-row threshold vector
    ``t``; the eig-fold of D^T D is one-time."""
    n = s.shape[0]
    D = DiffOp(n).dense(s.dtype, s.device)  # dense only for the one-time eig-fold
    A = StackIDiffOp(n)                     # matrix-free [I; D] inside the loop
    t = torch.cat((torch.full((n,), lam1, dtype=s.dtype, device=s.device),
                   torch.full((n,), lam2, dtype=s.dtype, device=s.device)))
    data = {"s": s, "t": t, "A": A}
    DtD = D.T @ D
    DtD = 0.5 * (DtD + DtD.T)
    w, V = torch.linalg.eigh(DtD)
    if config.dynamic_rho:
        data["V"], data["w"] = V, w
        prox_f = _prox_f_adaptive
    else:
        data["Minv"] = (V / (1.0 + config.rho * (1.0 + w))[None, :]) @ V.T
        prox_f = _prox_f
    prox_g = _prox_g if config.relax == 1.0 else _prox_g_relaxed
    return prox_f, prox_g, _obj, data, A


@register("fusedlasso")
def _registry_entry(s, lam1, lam2, config=ADMMConfig(), device=None, **_):
    s = as_tensor(s).to(resolve_device(device, s))
    pf, pg, obj, data, _A = make_prox_ops(s, lam1, lam2, config)
    return bind_data(pf, pg, obj, data)


@timed_solver
def fusedlasso(s, lam1, lam2, config: ADMMConfig = ADMMConfig(), *,
               x0=None, z0=None, u0=None, device=None, **overrides) -> ADMMResults:
    """Solve the fused lasso signal approximator.

    ``xopt`` is the denoised signal; ``zopt`` carries the stacked
    [x; Dx] auxiliary.  Constraint wiring: A = [I; D] (2n, n), B = -1,
    c = 0.  ``s`` is a numpy array or a tensor; the solve runs in its
    dtype on ``device``, or on s's device when s is a tensor, or on the
    CUDA device (``device.resolve_device``).
    """
    config = merge_config(config, overrides, body="gemv")
    device = resolve_device(device, s)
    s = as_tensor(s).to(device)
    n = s.shape[0]
    prox_f, prox_g, obj, data, A = make_prox_ops(s, lam1, lam2, config)
    return admm(
        prox_f, prox_g, config,
        A=A, B=-1.0, c=0.0, m=2 * n, nA=n, nB=2 * n,
        x0=x0, z0=z0, u0=u0,
        hooks=Hooks(obj=obj), dtype=s.dtype, data=data, device=device,
    )
