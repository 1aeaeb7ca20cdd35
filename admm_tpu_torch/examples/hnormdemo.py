"""H-norm stopping demo (port of ``examples/hnormdemo.py``).

Mirrors reference examples/hnormdemo.m: solve the same problem under the
three stopping conditions ('standard', 'hnorm', 'both', admm.m:705-722)
and show the H-norm trace decaying below hnormtol.

Usage:  python -m admm_tpu_torch.examples.hnormdemo [--device cpu]
"""

from __future__ import annotations

import argparse

import numpy as np


def hnormdemo(m=96, n=64, seed=0, quiet=False, device=None):
    from admm_tpu_torch import ADMMConfig, model

    rng = np.random.default_rng(seed)
    P, Q = rng.standard_normal((m, n)), rng.standard_normal((m, n))
    r, s = rng.standard_normal(m), rng.standard_normal(m)

    out = {}
    for stopcond in ("standard", "hnorm", "both"):
        res = model(P, Q, r, s, ADMMConfig(maxiters=5000, stopcond=stopcond, convtest=True),
                    device=device)
        h = np.asarray(res.Hnormsq)
        out[stopcond] = (res.steps, float(h[-1]))
        if not quiet:
            print(f"stopcond = {stopcond:>8}: {res.steps:>5} steps, final Hnorm^2 {h[-1]:.3e}")
    return out


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None)
    hnormdemo(device=ap.parse_args().device)
