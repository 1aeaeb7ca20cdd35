"""Distributed matrix-iterate solves: sharded SDP and consensus
covariance selection (port of ``examples/distributed_matrix.py``).

1. ``sdp_sharded``: a standard-form SDP whose (m, n, n) constraint stack
   is in shards (local contractions, the m residuals gathered, a
   replicated (m, m) Cholesky solve and the summed correction, the
   transpose-reduction pattern of solvers/unwrappedadmm.m:96-141 at SDP
   scale), checked against the serial solve and the instance's
   constructed optimum.
2. ``consensus_covsel``: graphical lasso over SAMPLE-sharded data (Boyd
   ch. 7 general-form consensus): each shard holds its rows' covariance
   contribution and solves a weighted spectral prox locally; only the
   (p, p) consensus average crosses the shards.  Checked against the
   serial ``covarianceselection`` objective.

Both run on ``mesh`` (default: 8 shards stacked on the solve's device;
over a process group, ``parallel.global_mesh()``).

Usage:  python -m admm_tpu_torch.examples.distributed_matrix [--device cpu]
"""

from __future__ import annotations

import argparse

import numpy as np


def demo(n=12, m=16, p=16, samples=240, nshards=None, quiet=False, *, mesh=None,
         device=None):
    """Returns {"sdp": {...}, "covsel": {...}} with the steps and the gaps
    to the serial solves (and to the SDP's constructed optimum)."""
    import torch

    from admm_tpu_torch import ADMMConfig, sdp
    from admm_tpu_torch.models._common import host64
    from admm_tpu_torch.models.covarianceselection import (_obj as covsel_obj,
                                                           covarianceselection,
                                                           empirical_covariance)
    from admm_tpu_torch.models.sdp import random_sdp_instance
    from admm_tpu_torch.parallel import consensus_covsel, make_mesh, sdp_sharded

    if mesh is None:
        mesh = make_mesh(8, device=device)
    dev = mesh.device
    W = nshards if nshards is not None else mesh.size
    cfg = ADMMConfig(maxiters=20000, abstol=1e-9, reltol=1e-9)
    t = lambda a: torch.as_tensor(a, dtype=torch.float64, device=dev)  # noqa: E731
    out = {}

    rng = np.random.default_rng(0)
    C, A, b, Xstar, _, _ = random_sdp_instance(n, m, n // 3, rng)
    ser = sdp(t(C), t(A), t(b), config=cfg)
    sh = sdp_sharded(t(C), t(A), t(b), config=cfg, mesh=mesh, nshards=W)
    Z = host64(sh.zopt)
    gap_serial = float(np.abs(Z - host64(ser.zopt)).max())
    gap_opt = float(np.abs(Z - Xstar).max())
    out["sdp"] = dict(shards=W, steps=int(sh.steps), max_dev_vs_serial=gap_serial,
                      max_dev_vs_opt=gap_opt)
    if not quiet:
        print(f"sdp_sharded ({W} shards, n={n}, m={m}): steps {sh.steps}, "
              f"|Z - Z_serial|_max {gap_serial:.2e}, |Z - X*|_max {gap_opt:.2e}")

    Sinv = np.eye(p) + 0.3 * np.triu(
        (rng.random((p, p)) < 0.15) * rng.standard_normal((p, p)), 1)
    Sinv = Sinv @ Sinv.T
    L = np.linalg.cholesky(np.linalg.inv(Sinv))
    D = t(rng.standard_normal((samples, p)) @ L.T)
    lam = 0.1
    ser_cv = covarianceselection(D, lam, cfg)
    con_cv = consensus_covsel(D, lam, cfg, mesh=mesh, nshards=W)
    dS = {"S": empirical_covariance(D), "lam": t(lam)}
    f_ser = float(covsel_obj(ser_cv.xopt, ser_cv.zopt, dS))
    f_con = float(covsel_obj(con_cv.xopt, con_cv.zopt, dS))
    out["covsel"] = dict(shards=W, steps=int(con_cv.steps), obj_serial=f_ser,
                         obj_consensus=f_con, obj_gap=abs(f_con - f_ser))
    if not quiet:
        print(f"consensus_covsel ({W} shards, p={p}, {samples} samples): "
              f"steps {con_cv.steps}, objective {f_con:.6f} vs serial "
              f"{f_ser:.6f} (gap {abs(f_con - f_ser):.2e})")
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None)
    args = ap.parse_args(argv)
    demo(device=args.device)


if __name__ == "__main__":
    main()
