"""Parallel vs serial unwrapped-ADMM SVM benchmark (port of
``examples/unwrappedadmmtest.py``).

Mirrors reference examples/unwrappedadmmtest.m:29-58: train the linear
SVM serially and with the distributed transpose-reduction path (the
reference's "Two-core" comparison on a local pool) across problem scales
and report runtimes and the agreement of the recovered separators.  The
sharded solve runs on ``mesh`` (default: 8 shards stacked on the solve's
device; ``parallel.global_mesh()`` over the ranks of a process group).

Usage:  python -m admm_tpu_torch.examples.unwrappedadmmtest [--device cpu]
"""

from __future__ import annotations

import argparse


def unwrappedadmmtest(scales=(7, 9, 11), C=1.0, seed=0, quiet=False, *, mesh=None,
                      nshards=None, device=None):
    """Returns {scale: (serial runtime, sharded runtime, separator slope
    gap)}; each solve runs twice and the second is timed, as the
    reference example does."""
    from admm_tpu_torch import ADMMConfig, linearsvm
    from admm_tpu_torch.models._common import host64
    from admm_tpu_torch.parallel import linearsvm_sharded, make_mesh
    from admm_tpu_torch.testers.problems import make_svm_instance

    if mesh is None:
        mesh = make_mesh(8 if nshards is None else nshards, device=device)
    out = {}
    for sc in scales:
        m = 2**sc
        D, ell = make_svm_instance(seed, m, m)
        cfg = ADMMConfig(maxiters=1000)
        serial = linearsvm(D, ell, C, cfg, device=mesh.device)
        serial = linearsvm(D, ell, C, cfg, device=mesh.device)
        par = linearsvm_sharded(D, ell, C, cfg, mesh=mesh, nshards=nshards)
        par = linearsvm_sharded(D, ell, C, cfg, mesh=mesh, nshards=nshards)
        xs, xp = host64(serial.xopt), host64(par.xopt)
        slope_gap = abs((-xs[1] / xs[0]) - (-xp[1] / xp[0]))
        out[sc] = (serial.runtime, par.runtime, slope_gap)
        if not quiet:
            print(f"2^{sc} rows: serial {serial.runtime:.3f}s, "
                  f"sharded({par.extra['nshards']} shards) {par.runtime:.3f}s, "
                  f"separator gap {slope_gap:.2e}")
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None)
    args = ap.parse_args(argv)
    unwrappedadmmtest(device=args.device)


if __name__ == "__main__":
    main()
