"""Standard vs fast vs accelerated ADMM comparison (port of
``examples/fasteradmmcomparison.py``).

Mirrors reference examples/fasteradmmcomparison.m: solve the same model
problem with alg 0 (standard), alg 1 (fast, strong convexity) and alg 2
(accelerated with restart) and compare steps-to-convergence, x-error,
and wall time.

Usage:  python -m admm_tpu_torch.examples.fasteradmmcomparison [m] [n] [--device cpu]
"""

from __future__ import annotations

import argparse

import numpy as np


def fasteradmmcomparison(m=128, n=96, seed=0, maxiters=5000, quiet=False, device=None):
    from admm_tpu_torch import ADMMConfig, model
    from admm_tpu_torch.models._common import host64

    rng = np.random.default_rng(seed)
    P, Q = rng.standard_normal((m, n)), rng.standard_normal((m, n))
    r, s = rng.standard_normal(m), rng.standard_normal(m)
    truex = np.linalg.solve(P.T @ P + Q.T @ Q, P.T @ r + Q.T @ s)

    variants = {
        "standard": ADMMConfig(maxiters=maxiters),
        "fast (strong)": ADMMConfig(maxiters=maxiters, fast=True, fasttype="strong"),
        "accelerated+restart (weak)": ADMMConfig(maxiters=maxiters, fast=True, fasttype="weak"),
    }
    out = {}
    for name, cfg in variants.items():
        res = model(P, Q, r, s, cfg, device=device)
        xerr = float(np.linalg.norm(host64(res.xopt) - truex))
        out[name] = (res.steps, xerr, res.runtime)
        if not quiet:
            print(f"{name:>28}: {res.steps:>5} steps, x-err {xerr:.2e}, {res.runtime:.3f}s")
    return out


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("dims", type=int, nargs="*")
    ap.add_argument("--device", default=None)
    a = ap.parse_args()
    fasteradmmcomparison(*a.dims[:2], device=a.device)
