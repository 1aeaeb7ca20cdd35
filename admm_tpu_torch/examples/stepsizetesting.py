"""Step-size (rho) study (port of ``examples/stepsizetesting.py``).

Mirrors reference examples/stepsizetesting.m: run a tester across a list
of rho values and report steps-to-convergence and pass/fail per rho.

Usage:  python -m admm_tpu_torch.examples.stepsizetesting [solver] [--device cpu]
"""

from __future__ import annotations

import argparse


def stepsizetesting(rhos=(0.1, 0.5, 1.0, 2.0, 10.0), tester="model", seed=0, quiet=False,
                    device=None, **tester_kwargs):
    from admm_tpu_torch import ADMMConfig
    from admm_tpu_torch.testers import problems as p

    tester_fn = getattr(p, f"{tester}test")
    out = {}
    for rho in rhos:
        cfg = ADMMConfig(rho=float(rho))
        if tester == "linearsvm":
            res, _, test = tester_fn(seed=seed, quiet=True, config=cfg, device=device,
                                     **tester_kwargs)
        else:
            res, test = tester_fn(seed=seed, quiet=True, config=cfg, device=device,
                                  **tester_kwargs)
        out[rho] = (res.steps, not test["failed"])
        if not quiet:
            print(f"rho = {rho:>6}: {res.steps:>6} steps, "
                  f"{'pass' if not test['failed'] else 'FAIL'}")
    return out


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("solver", nargs="?", default="model")
    ap.add_argument("--device", default=None)
    a = ap.parse_args()
    stepsizetesting(tester=a.solver, device=a.device)
