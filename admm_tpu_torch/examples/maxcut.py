"""Goemans-Williamson max-cut: a batch of SDP relaxations + randomized
rounding on the batched SDP solver (port of ``examples/maxcut.py``).

For each graph with Laplacian L, solve the relaxation

    max  (1/4) <L, X>   s.t.  diag(X) = 1,  X >= 0 (PSD)

as ``sdp_batch(-L/4, 'diag', 1)``, all graphs as lanes of one solve.
Rounding (on the host, numpy, the reference's draws from the same seed):
factor X = V^T V, draw random hyperplanes, take the best signed cut.  GW
theory guarantees E[cut] >= 0.878 * SDP >= 0.878 * OPT; the demo reports
the measured ratio per graph.

Usage:  python -m admm_tpu_torch.examples.maxcut [--device cpu]
"""

from __future__ import annotations

import argparse

import numpy as np


def random_graphs(n_nodes=24, n_graphs=4, p=0.3, seed=0):
    rng = np.random.default_rng(seed)
    Ls = []
    for _ in range(n_graphs):
        W = np.triu((rng.random((n_nodes, n_nodes)) < p).astype(float), 1)
        W = W + W.T
        Ls.append(np.diag(W.sum(1)) - W)
    return np.stack(Ls)


def gw_round(X, L, n_draws=200, seed=0):
    """Random-hyperplane rounding of one PSD relaxation solution."""
    rng = np.random.default_rng(seed)
    e, Q = np.linalg.eigh(0.5 * (X + X.T))
    V = (Q * np.sqrt(np.maximum(e, 0.0))).T  # X = V^T V
    g = rng.standard_normal((n_draws, V.shape[0]))
    signs = np.sign(g @ V)
    signs[signs == 0] = 1.0
    cuts = 0.25 * np.einsum("di,ij,dj->d", signs, L, signs)
    best = int(np.argmax(cuts))
    return float(cuts[best]), signs[best]


def maxcut_demo(n_nodes=24, n_graphs=4, seed=0, maxiters=20000, quiet=False, device=None):
    from admm_tpu_torch import ADMMConfig, sdp_batch
    from admm_tpu_torch.models._common import host64

    Ls = random_graphs(n_nodes, n_graphs, seed=seed)
    cfg = ADMMConfig(maxiters=maxiters, abstol=1e-8, reltol=1e-8, stallwindow=200)
    out = sdp_batch(-0.25 * Ls, "diag", np.ones(n_nodes), cfg, device=device)
    Z, steps = host64(out.zopt), host64(out.steps)

    rows = []
    for i in range(n_graphs):
        X = Z[i]
        sdp_val = 0.25 * float(np.sum(Ls[i] * X))
        cut, _ = gw_round(X, Ls[i], seed=seed + i)
        rows.append((i, sdp_val, cut, cut / max(sdp_val, 1e-12), int(steps[i])))
    if not quiet:
        print(f"{'graph':>6} {'SDP bound':>10} {'GW cut':>8} {'ratio':>7} {'steps':>6}")
        for i, s, c, r, k in rows:
            print(f"{i:>6} {s:>10.3f} {c:>8.1f} {r:>7.3f} {k:>6}")
    return rows


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None)
    maxcut_demo(device=ap.parse_args().device)
