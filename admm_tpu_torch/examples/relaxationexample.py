"""Over/under-relaxation study (port of ``examples/relaxationexample.py``).

Mirrors reference examples/relaxationexample.m: sweep the relaxation
parameter (admm.m:515-532; typical range 1.0..1.8) on a LAD instance with
the relaxation-aware z-prox (lad.m:124-126) and report the effect on
steps-to-convergence.

Usage:  python -m admm_tpu_torch.examples.relaxationexample [--device cpu]
"""

from __future__ import annotations

import argparse

import numpy as np


def relaxationexample(relaxes=(0.8, 1.0, 1.2, 1.5, 1.8), rows=512, cols=32, seed=0,
                      quiet=False, device=None):
    from admm_tpu_torch import ADMMConfig, lad
    from admm_tpu_torch.models._common import host64

    rng = np.random.default_rng(seed)
    D = rng.standard_normal((rows, cols))
    xtrue = 10.0 * rng.standard_normal(cols)
    s = D @ xtrue
    idx = rng.choice(rows, size=int(np.ceil(rows / 50)), replace=False)
    s[idx] += 100.0 * rng.standard_normal(len(idx))

    out = {}
    for relax in relaxes:
        res = lad(D, s, ADMMConfig(relax=float(relax), maxiters=5000), device=device)
        xerr = float(np.linalg.norm(host64(res.xopt) - xtrue))
        out[relax] = (res.steps, xerr)
        if not quiet:
            print(f"relax = {relax:>4}: {res.steps:>5} steps, x-err {xerr:.2e}")
    return out


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None)
    relaxationexample(device=ap.parse_args().device)
