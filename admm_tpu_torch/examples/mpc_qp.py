"""Receding-horizon (MPC-style) batched QP with warm starts (port of
``examples/mpc_qp.py``).

- A fleet of B controllers shares one QP structure (Hessian P, equality
  matrix D) whose KKT system is folded once (``qp_structure``).
- At every control step the linear terms change, so the fleet re-solves
  as the lanes of one ``qp_batch`` solve.
- Each re-solve warm-starts from the previous step's solution
  (x0/z0/u0 = the previous BatchResults), cutting iterations several-fold.

Usage:  python -m admm_tpu_torch.examples.mpc_qp [B] [n] [steps] [--device cpu]
"""

from __future__ import annotations

import argparse

import numpy as np


def mpc_qp(B=16, n=64, m=16, steps=8, seed=0, maxiters=2000, quiet=False, device=None):
    from admm_tpu_torch import ADMMConfig, qp_batch, qp_structure
    from admm_tpu_torch.models._common import host64

    if m >= n:
        raise ValueError(f"the equality system must be underdetermined (m < n); "
                         f"got m={m}, n={n}")
    rng = np.random.default_rng(seed)
    R = rng.standard_normal((n, 2 * n))
    P = R @ R.T / (2 * n) + 0.1 * np.eye(n)
    D = rng.standard_normal((m, n))
    struct = qp_structure(P, D, device=device)

    # Tight Boyd tolerances so warm and cold stops land on the same solution.
    cfg = ADMMConfig(maxiters=maxiters, abstol=1e-8, reltol=1e-7)
    cold_iters, warm_iters = [], []
    prev = None
    Qs = rng.standard_normal((B, n))
    Ss = np.abs(rng.standard_normal((B, n))) @ D.T
    for t in range(steps):
        Qs = Qs + 0.01 * rng.standard_normal((B, n))
        Ss = Ss + 0.01 * np.abs(rng.standard_normal((B, n))) @ D.T

        cold = qp_batch(P, Qs, 0.0, D, Ss, cfg, structure=struct, device=device)
        cold_iters.append(int(host64(cold.steps).max()))
        if prev is None:
            warm = cold
        else:
            warm = qp_batch(P, Qs, 0.0, D, Ss, cfg, structure=struct, x0=prev.xopt,
                            z0=prev.zopt, u0=prev.uopt, device=device)
        warm_iters.append(int(host64(warm.steps).max()))
        np.testing.assert_allclose(host64(warm.xopt), host64(cold.xopt), atol=1e-3)
        prev = warm

    if not quiet:
        print(f"{'step':>4} {'cold iters':>11} {'warm iters':>11}")
        for t, (c, w) in enumerate(zip(cold_iters, warm_iters)):
            print(f"{t:>4} {c:>11} {w:>11}")
        sc, sw = sum(cold_iters[1:]), sum(warm_iters[1:])
        print(f"total re-solve iterations: cold {sc}, warm {sw} "
              f"({sc / max(sw, 1):.1f}x fewer warm)")
    return cold_iters, warm_iters


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("dims", type=int, nargs="*")
    ap.add_argument("--device", default=None)
    a = ap.parse_args()
    mpc_qp(**dict(zip(("B", "n", "steps"), a.dims)), device=a.device)
