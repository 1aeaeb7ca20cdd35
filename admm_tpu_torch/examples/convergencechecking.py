"""Convergence-monitor fault-injection demo (port of
``examples/convergencechecking.py``).

Mirrors reference examples/convergencechecking.m: run the model problem
with deliberately broken proximal operators (sign errors, flagged at
convergencechecking.m:198, 235) in all four combinations (ok/ok,
broken-f, broken-g, both) and show the H-norm divergence monitor
(admm.m:686-703) catching the broken ones while the correct pair
converges (convergencechecking.m:124-157).

Usage:  python -m admm_tpu_torch.examples.convergencechecking [m] [n] [--device cpu]
"""

from __future__ import annotations

import argparse

import numpy as np
import torch


def convergencechecking(m=64, n=48, seed=0, quiet=False, device=None):
    from admm_tpu_torch import ADMMConfig, Hooks, admm
    from admm_tpu_torch.device import resolve_device
    from admm_tpu_torch.models._common import bind_data
    from admm_tpu_torch.models.model import make_prox_ops

    rng = np.random.default_rng(seed)
    P, Q = rng.standard_normal((m, n)), rng.standard_normal((m, n))
    r, s = rng.standard_normal(m), rng.standard_normal(m)
    dev = resolve_device(device)

    cfg = ADMMConfig(convtest=True, maxiters=200, objevals=True)
    ops = [torch.as_tensor(a, device=dev) for a in (P, Q, r, s)]
    pf, pg, obj = bind_data(*make_prox_ops(*ops, cfg))

    # The deliberate sign errors (convergencechecking.m:198, 235).
    bad_pf = lambda x, z, u, rho: pf(x, z, -u, rho)  # noqa: E731
    bad_pg = lambda x, z, u, rho: pg(x, z, -u, rho)  # noqa: E731

    combos = {
        "ok-f / ok-g": (pf, pg),
        "BROKEN-f / ok-g": (bad_pf, pg),
        "ok-f / BROKEN-g": (pf, bad_pg),
        "BROKEN-f / BROKEN-g": (bad_pf, bad_pg),
    }
    out = {}
    for name, (f_, g_) in combos.items():
        res = admm(f_, g_, cfg, A=1.0, B=-1.0, c=0.0, m=n, hooks=Hooks(obj=obj),
                   dtype=ops[0].dtype, device=dev)
        out[name] = res
        if not quiet:
            status = "DIVERGED (caught by monitor)" if res.diverged else "converged"
            print(f"{name:>22}: {status} after {res.steps} steps, "
                  f"final Hnorm^2 {np.asarray(res.Hnormsq)[-1]:.3e}")
    if out["ok-f / ok-g"].diverged:
        raise RuntimeError("convergencechecking: the correct prox pair was flagged as diverged")
    return out


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("dims", type=int, nargs="*")
    ap.add_argument("--device", default=None)
    a = ap.parse_args()
    convergencechecking(*a.dims[:2], device=a.device)
