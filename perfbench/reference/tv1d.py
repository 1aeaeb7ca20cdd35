"""Plain ADMM for 1-D total-variation denoising
min 1/2 ||x - s||^2 + lam ||z||_1  s.t.  D x - z = 0
(Boyd et al. 2011, section 6.4.1; ``total_variation.m``), over lanes.

D is the n x n difference operator (D x)_i = x_i - x_{i+1} for i < n and
(D x)_n = x_n.  The x-update solves the fixed tridiagonal system
(I + rho D^T D) x = s + rho D^T (z - u) by an LDL^T factorisation made
here, its two bidiagonal sweeps each a linear recurrence evaluated by
recursive doubling (log2 n vector steps).  z = S_{lam/rho}(D x + u),
u += D x - z; the Boyd stop: ||D x - z|| < sqrt(n) abstol + reltol
max(||D x||, ||z||) and rho ||D^T (z - z_prev)|| < sqrt(n) abstol + reltol
rho ||D^T u||.
"""

from __future__ import annotations

import numpy as np
import torch

from .common import DTYPES, Lanes, boyd_errors, rownorm, soft_threshold


def _dx(v):
    return v - torch.nn.functional.pad(v[:, 1:], (0, 1))


def _dtx(v):
    return v - torch.nn.functional.pad(v[:, :-1], (1, 0))


def ldl(n, rho):
    """The pivots d and multipliers l (l[0] = 0) of I + rho D^T D =
    L diag(d) L^T, in float64 on the host."""
    a = 1.0 + rho * np.r_[1.0, 2.0 * np.ones(n - 1)]
    off = -rho
    d = np.empty(n)
    l = np.zeros(n)
    d[0] = a[0]
    for i in range(1, n):
        l[i] = off / d[i - 1]
        d[i] = a[i] - off * l[i]
    return d, l


def affine_scan(alpha, beta):
    """y with y_i = alpha_i y_{i-1} + beta_i along the last axis (y_{-1} =
    0), by recursive doubling."""
    A, B = alpha, beta
    n = B.shape[-1]
    shift = 1
    while shift < n:
        B = torch.cat((B[..., :shift], B[..., shift:] + A[..., shift:] * B[..., :-shift]), -1)
        A = torch.cat((A[..., :shift], A[..., shift:] * A[..., :-shift]), -1)
        shift *= 2
    return B


def tridiagonal_solver(n, rho, dtype, device):
    """x = (I + rho D^T D)^{-1} b for b of shape (L, n)."""
    d, l = ldl(n, rho)
    d_t = torch.as_tensor(d, device=device).to(dtype)
    fwd = torch.as_tensor(-l, device=device).to(dtype)
    bwd = torch.as_tensor(np.r_[0.0, -l[1:][::-1]].copy(), device=device).to(dtype)

    def solve(b):
        y = affine_scan(fwd.expand_as(b), b)
        return affine_scan(bwd.expand_as(b), (y / d_t).flip(-1)).flip(-1)

    return solve


def admm_tv(S, lams, *, rho, abstol, reltol, maxiters, stop_at=None, precision="float64"):
    """Run one lane per row of ``S`` (L, n) with its own entry of
    ``lams`` from x = z = u = 0.  Returns ``(x, z, u, own_steps)`` as
    ``lasso.admm_lasso`` does."""
    dt = DTYPES[precision]
    S = S.to(dt)
    L, n = S.shape
    lams = torch.as_tensor(lams).to(device=S.device, dtype=dt).reshape(-1)
    solve = tridiagonal_solver(n, rho, dt, S.device)
    x = torch.zeros_like(S)
    z, u = x.clone(), x.clone()
    thresh = (lams / rho)[:, None]
    lanes = Lanes(L, (n, n, n), stop_at, maxiters, S.device, dt)
    for k in range(1, maxiters + 1):
        x = solve(S + rho * _dtx(z - u))
        Dx = _dx(x)
        zprev = z
        z = soft_threshold(u + Dx, thresh)
        u = u + Dx - z
        perr, derr = boyd_errors(n, abstol, reltol, torch.maximum(rownorm(Dx), rownorm(z)),
                                 rho * rownorm(_dtx(u)))
        stop = (rownorm(Dx - z) < perr) & (rho * rownorm(_dtx(z - zprev)) < derr)
        if lanes.update(k, stop, (x, z, u)):
            break
    return lanes.result()
