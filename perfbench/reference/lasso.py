"""Plain ADMM for the LASSO  min 1/2 ||D x - s||^2 + lam ||z||_1  s.t.  x = z
(Boyd et al. 2011, section 6.4; ``lasso_example.m``), over lanes of lam.

The x-update solves (D^T D + rho I) x = D^T s + rho (z - u) by the
matrix-inversion lemma for a fat D:
x = (q - D^T (rho I + D D^T)^{-1} D q) / rho, with the m x m inverse from a
Cholesky factorisation made here.  z = S_{lam/rho}(x + u), u += x - z;
the Boyd stop: ||x - z|| < sqrt(n) abstol + reltol max(||x||, ||z||) and
rho ||z - z_prev|| < sqrt(n) abstol + reltol rho ||u||.
"""

from __future__ import annotations

import torch

from .common import DTYPES, Lanes, boyd_errors, full_precision_matmul, matmul, rownorm, \
    soft_threshold


def admm_lasso(D, s, lams, *, rho, abstol, reltol, maxiters, stop_at=None,
               precision="float64"):
    """Run one lane per entry of ``lams`` from x = z = u = 0.

    Returns ``(x, z, u, own_steps)``: each lane's iterate at ``stop_at[b]``
    where given, else at its own stop, and the step at which each lane's
    own stop fires.  ``precision`` is a key of ``common.DTYPES``."""
    dt = DTYPES[precision]
    mm = matmul(precision)
    with full_precision_matmul():
        D = D.to(dt)
        s = s.to(dt)
        m, n = D.shape
        lams = torch.as_tensor(lams).to(device=D.device, dtype=dt).reshape(-1)
        L = lams.shape[0]
        G = mm(D, D.T) + rho * torch.eye(m, dtype=dt, device=D.device)
        M = torch.cholesky_inverse(torch.linalg.cholesky(G))
        Dts = mm(s[None, :], D)[0]
        x = torch.zeros((L, n), dtype=dt, device=D.device)
        z, u = x.clone(), x.clone()
        thresh = (lams / rho)[:, None]
        lanes = Lanes(L, (n, n, n), stop_at, maxiters, D.device, dt)
        for k in range(1, maxiters + 1):
            q = Dts + rho * (z - u)
            w = mm(mm(q, D.T), M)
            x = (q - mm(w, D)) / rho
            zprev = z
            z = soft_threshold(x + u, thresh)
            u = u + x - z
            perr, derr = boyd_errors(n, abstol, reltol,
                                     torch.maximum(rownorm(x), rownorm(z)), rho * rownorm(u))
            stop = (rownorm(x - z) < perr) & (rho * rownorm(z - zprev) < derr)
            if lanes.update(k, stop, (x, z, u)):
                break
    return lanes.result()
