"""Plain consensus ADMM for the LASSO with its rows in W shards (Boyd et
al. 2011, section 8.2.1: the lasso split across examples; the reference
project's parallel LASSO, getProxOps.m:1217-1326), as the port's
``parallel/consensus.py`` states it:

    x_i  = argmin 1/2 ||D_i x - s_i||^2 + rho/2 ||x - z + u_i||^2
    xbar = mean_i x_i,  ubar = mean_i u_i
    z    = S_{lam/(rho W)}(xbar + ubar)
    u_i += x_i - z

with the residuals kept squared, pnorm = sum_i ||x_i - xbar||^2 and
dnorm = W rho^2 ||xbar - xbar_prev||^2, and compared against the linear
Boyd tolerances perr = sqrt(n) abstol + reltol max(||xbar||, ||z||) and
derr = sqrt(n) abstol + reltol rho ||ubar||, ubar the dual mean after the
update (the reference project's ``lassonorms``, which the port keeps).

The local solve is the Woodbury form for a fat shard,
x_i = (q - D_i^T (rho I + D_i D_i^T)^{-1} D_i q) / rho with
q = D_i^T s_i + rho (z - u_i), the m_i x m_i inverse from a Cholesky
factorisation made here: not the port's n x n inverse.

The shards come in blocks: this process holds (w, m_i, n) of them.  Over
a ``torch.distributed`` group each rank holds its own block, and every
sum over the shards is the block's sum followed by one plain
``all_reduce``; without a group the block is all W shards.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from .common import DTYPES, Lanes, boyd_errors, full_precision_matmul, matmul, rownorm, \
    soft_threshold


def admm_consensus_lasso(Di, si, lam, nshards, *, rho, abstol, reltol, maxiters,
                         stop_at=None, precision="float64", group=None):
    """Run consensus ADMM from x_i = u_i = z = 0 over this block's shards
    ``Di`` (w, m_i, n) and ``si`` (w, m_i), ``nshards`` W in all.

    Returns ``(x, z, u, own_steps)``: xbar, z and ubar, each (1, n), at
    step ``stop_at[0]`` where given, else at the reference's own stop, and
    ``[own stop]``.  ``precision`` is a key of ``common.DTYPES``."""
    dt = DTYPES[precision]
    mm = matmul(precision)
    W = int(nshards)

    def total(*parts):
        # Sums over every shard of the group: the block's, then the ranks'.
        flat = torch.cat([p.reshape(-1) for p in parts])
        if group is not None:
            dist.all_reduce(flat, group=group)
        out, at = [], 0
        for p in parts:
            out.append(flat[at:at + p.numel()].reshape(p.shape))
            at += p.numel()
        return out

    with full_precision_matmul():
        D = Di.to(dt)
        s = si.to(dt)
        w, mi, n = D.shape
        eye = torch.eye(mi, dtype=dt, device=D.device)
        G = mm(D, D.mT) + rho * eye
        # torch has no bfloat16 Cholesky: that one factorisation runs in
        # float32 on the bfloat16 inputs, its inverse rounded back.
        fdt = torch.float32 if dt == torch.bfloat16 else dt
        K = torch.cholesky_inverse(torch.linalg.cholesky(G.to(fdt))).to(dt)
        Dts = mm(s[:, None, :], D)[:, 0]                          # (w, n)
        x = torch.zeros((w, n), dtype=dt, device=D.device)
        u = torch.zeros_like(x)
        z = torch.zeros(n, dtype=dt, device=D.device)
        xbar_prev = torch.zeros_like(z)
        thresh = float(lam) / (rho * W)
        lanes = Lanes(1, (n, n, n), stop_at, maxiters, D.device, dt)
        for k in range(1, maxiters + 1):
            q = Dts + rho * (z[None, :] - u)
            y = mm(K, mm(D, q[..., None]))                        # (w, m_i, 1)
            x = (q - mm(D.mT, y)[..., 0]) / rho
            xsum, usum = total(x.sum(dim=0), u.sum(dim=0))
            xbar, ubar = xsum / W, usum / W
            z = soft_threshold(xbar + ubar, thresh)
            u = u + x - z[None, :]
            ubar = ubar + xbar - z
            (pnorm,) = total(torch.sum((x - xbar[None, :]) ** 2))
            dnorm = W * rho**2 * torch.sum((xbar - xbar_prev) ** 2)
            xbar_prev = xbar
            perr, derr = boyd_errors(n, abstol, reltol,
                                     torch.maximum(rownorm(xbar), rownorm(z)), rho * rownorm(ubar))
            stop = ((pnorm < perr) & (dnorm < derr)).reshape(1)
            if lanes.update(k, stop, (xbar[None], z[None], ubar[None])):
                break
    return lanes.result()
