"""Markowitz portfolio optimization: the efficient frontier as one
batched QP solve (port of ``examples/portfolio.py``).

The whole risk-aversion sweep

    min_x  (gamma/2) x^T Sigma x - mu^T x
    s.t.   1^T x = 1,  x >= 0            (long-only, fully invested)

is rescaled to the shared-structure form  min 1/2 x^T Sigma x + q_g^T x
with q_g = -mu/gamma, so every gamma shares the (Sigma, constraint, rho)
KKT fold and the sweep runs as the lanes of one ``qp_batch`` solve.

Usage:  python -m admm_tpu_torch.examples.portfolio [--device cpu]
"""

from __future__ import annotations

import argparse

import numpy as np


def efficient_frontier(n_assets=32, n_factors=4, n_gammas=16, seed=0, maxiters=6000,
                       quiet=False, device=None):
    from admm_tpu_torch import ADMMConfig, qp_batch
    from admm_tpu_torch.models._common import host64

    rng = np.random.default_rng(seed)
    # Factor-model covariance and expected returns loosely aligned with risk.
    F = rng.standard_normal((n_assets, n_factors)) / np.sqrt(n_factors)
    Sigma = F @ F.T + np.diag(0.05 + 0.2 * rng.random(n_assets))
    mu = 0.03 + 0.10 * rng.random(n_assets) + 0.05 * np.diag(Sigma)

    gammas = np.logspace(-0.5, 1.5, n_gammas)
    Qs = (-mu[None, :] / gammas[:, None]).astype(np.float64)
    D = np.ones((1, n_assets))
    s = np.array([1.0])

    cfg = ADMMConfig(maxiters=maxiters, abstol=1e-9, reltol=1e-9)
    out = qp_batch(Sigma, Qs, 0.0, D, s, cfg, device=device)
    Wts = host64(out.zopt)  # the feasible (projected) iterate

    rows = []
    for g, w in zip(gammas, Wts):
        rows.append((float(g), float(mu @ w), float(np.sqrt(w @ Sigma @ w)), float(w.sum()),
                     float(w.min())))
    if not quiet:
        print(f"{'gamma':>8} {'return':>8} {'vol':>8} {'sum(w)':>8} {'min(w)':>9}")
        for g, ret, vol, sw, mn in rows:
            print(f"{g:8.3f} {ret:8.4f} {vol:8.4f} {sw:8.5f} {mn:9.2e}")
    return rows


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None)
    efficient_frontier(device=ap.parse_args().device)
