"""Anderson acceleration + Ruiz preconditioning study (port of
``examples/acceleration.py``).

Two demonstrations:

1. Acceleration ladder on a tight-tolerance LASSO: plain vs fast vs
   Anderson windows -- AA converges where both baselines burn the cap.

``maxiters`` (the reference's fixed 20000 and 40000 by default) caps each
solve.
2. A badly row/column-scaled LP: plain ADMM stalls infeasible;
   ``precondition=True`` recovers the optimum, and AA stacks on top.

Usage:  python -m admm_tpu_torch.examples.acceleration [--device cpu]
"""

from __future__ import annotations

import argparse

import numpy as np


def acceleration_ladder(rows=200, cols=400, seed=0, quiet=False, device=None, maxiters=20000):
    from admm_tpu_torch import ADMMConfig, lasso
    from admm_tpu_torch.models._common import host64

    rng = np.random.default_rng(seed)
    D = rng.standard_normal((rows, cols))
    s = rng.standard_normal(rows)
    lam = 0.1 * np.max(np.abs(D.T @ s))
    tol = dict(abstol=1e-8, reltol=1e-8, maxiters=maxiters)
    obj = lambda z: (0.5 * np.sum((D @ host64(z) - s) ** 2)  # noqa: E731
                     + lam * np.sum(np.abs(host64(z))))

    out = {}
    for name, kw in (("plain", {}), ("fast", dict(fast=True)),
                     ("anderson m=5", dict(anderson=5)),
                     ("anderson m=10", dict(anderson=10)),
                     ("anderson m=20", dict(anderson=20))):
        res = lasso(D, s, lam, ADMMConfig(**tol, **kw), device=device)
        out[name] = (int(res.steps), obj(res.zopt))
        if not quiet:
            print(f"{name:14s} steps {out[name][0]:6d}  objective {out[name][1]:.8f}")
    return out


def badly_scaled_lp(m=40, n=120, spread=2.0, seed=0, quiet=False, device=None,
                    maxiters=40000):
    from admm_tpu_torch import ADMMConfig, linearprogram
    from admm_tpu_torch.models._common import host64

    rng = np.random.default_rng(seed)
    D = rng.standard_normal((m, n))
    s = D @ np.abs(rng.standard_normal(n))
    b = np.abs(rng.standard_normal(n)) + 0.1
    G = 10.0 ** rng.uniform(-spread, spread, m)
    F = 10.0 ** rng.uniform(-spread, spread, n)
    Db, sb, bb = G[:, None] * D * F[None, :], G * s, F * b

    out = {}
    for name, kw in (("plain (bad scaling)", dict()),
                     ("precondition", dict(precondition=True)),
                     ("precondition + AA", dict(precondition=True, anderson=10))):
        res = linearprogram(bb, Db, sb,
                            ADMMConfig(abstol=1e-8, reltol=1e-8, maxiters=maxiters,
                                       anderson=kw.pop("anderson", 0)),
                            device=device, **kw)
        x = host64(res.xopt)
        fobj = float(bb @ x)
        # Violations in the ORIGINAL (bad) coordinates: the x-prox enforces
        # Dx = s each iteration, so a cap-burned plain run shows its
        # failure as negative entries (the cone violation).
        eq_viol = float(np.linalg.norm(Db @ x - sb) / np.linalg.norm(sb))
        cone_viol = float(max(0.0, -np.min(x)))
        out[name] = (int(res.steps), fobj, eq_viol, cone_viol)
        if not quiet:
            print(f"{name:22s} steps {out[name][0]:6d}  obj {fobj:12.6f}  "
                  f"eq viol {eq_viol:.2e}  cone viol {cone_viol:.2e}")
    return out


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None)
    dev = ap.parse_args().device
    print("== Acceleration ladder (tight-tolerance LASSO) ==")
    acceleration_ladder(device=dev)
    print("\n== Badly scaled LP (row/col scales 10^+-2) ==")
    badly_scaled_lp(device=dev)
