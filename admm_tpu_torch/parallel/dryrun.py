"""A dry run of the distributed layer over an n-position mesh (the twin
of ``__graft_entry__.dryrun_multichip``).

Every sharded form runs once at a small size on ``mesh``: 8 positions
stacked on one device by default, or the current process group
(``global_mesh()``, every rank calling ``dryrun`` with the same
arguments).  The bars are ``admm_tpu``'s: the consensus LASSO objective
within 1e-2 of a serial solve's, the Anderson run no slower than the
plain one and within the same bar, the transpose-reduction SVM variants
finite after two steps, sliced proxes exact, a finite hypergradient
through the sharded fixed point, sharded lanes equal to the plain lanes,
the exchange market at its closed-form equilibrium, the sharded SDP at
the serial solve (in float64) and consensus covariance selection at the
serial objective.  Data is float32, made from seed 0 on every rank alike.

Usage:  python -m admm_tpu_torch.parallel.dryrun [--devices 8] [--device cpu]
"""

from __future__ import annotations

import argparse
import json

import numpy as np
import torch


def _check(ok, what):
    if not ok:
        raise AssertionError(f"dryrun: {what}")


def dryrun(n_devices: int = 8, *, mesh=None, device=None) -> dict:
    """Run every sharded form over ``mesh`` (default ``make_mesh(n_devices,
    device=device)``); raises ``AssertionError`` at the first missed bar,
    else returns a dict of what each form gave."""
    from admm_tpu_torch import ADMMConfig, lasso, lasso_batch, make_implicit_consensus_solver
    from admm_tpu_torch import sdp
    from admm_tpu_torch.models._common import host64
    from admm_tpu_torch.models.covarianceselection import _obj as covsel_obj
    from admm_tpu_torch.models.covarianceselection import (covarianceselection,
                                                           empirical_covariance)
    from admm_tpu_torch.models.sdp import random_sdp_instance
    from admm_tpu_torch.parallel import (consensus_covsel, consensus_elasticnet,
                                         consensus_lasso, exchange_quadratic,
                                         linearsvm_sharded, make_mesh, make_sliced_prox,
                                         sdp_sharded)
    from admm_tpu_torch.parallel.consensus import (_lasso_global_prox, _lasso_local_prox,
                                                   ls_setup)
    from admm_tpu_torch.parallel.mesh import pad_rows, shard_rows
    from admm_tpu_torch.utils.validate import slicemaker

    if mesh is None:
        mesh = make_mesh(n_devices, device=device)
    n_devices = mesh.size
    dev = mesh.device
    t = lambda a: torch.as_tensor(np.asarray(a, np.float32), device=dev)  # noqa: E731
    rng = np.random.default_rng(0)
    rows, cols = 16 * n_devices, 16
    D = rng.standard_normal((rows, cols)).astype(np.float32)
    s = rng.standard_normal(rows).astype(np.float32)
    lam = 0.1
    obj = lambda x: 0.5 * np.sum((D @ x - s) ** 2) + lam * np.sum(np.abs(x))  # noqa: E731
    out = {}

    res = consensus_lasso(t(D), t(s), lam, ADMMConfig(maxiters=200), mesh=mesh,
                          nshards=n_devices)
    z = host64(res.zopt)
    _check(res.steps > 0 and np.all(np.isfinite(z)), "consensus not finite")
    serial = lasso(t(D), t(s), lam, ADMMConfig(maxiters=2000))
    f_par, f_ser = obj(z), obj(host64(serial.xopt))
    _check(abs(f_par - f_ser) <= 1e-2 * abs(f_ser),
           f"{n_devices}-shard consensus objective {f_par} vs serial {f_ser}")
    out["consensus"] = dict(steps=int(res.steps), objective=float(f_par), serial=float(f_ser))

    res_f = consensus_lasso(t(D), t(s), lam, ADMMConfig(maxiters=20, fast=True), mesh=mesh,
                            nshards=n_devices)
    _check(np.all(np.isfinite(host64(res_f.zopt))), "fast consensus not finite")
    res_aa = consensus_lasso(t(D), t(s), lam, ADMMConfig(maxiters=200, anderson=5), mesh=mesh,
                             nshards=n_devices)
    f_aa = obj(host64(res_aa.zopt))
    _check(abs(f_aa - f_ser) <= 1e-2 * abs(f_ser), f"AA consensus objective {f_aa} vs {f_ser}")
    _check(int(res_aa.steps) <= int(res.steps), "AA consensus took more steps")
    out["consensus_anderson"] = dict(steps=int(res_aa.steps), objective=float(f_aa))

    ell = np.sign(rng.standard_normal(rows)).astype(np.float32)
    for vkw in ({}, dict(fast=True), dict(relax=1.5)):
        r2 = linearsvm_sharded(t(D[:, :2]), t(ell), 1.0,
                               ADMMConfig(maxiters=2, domaxiters=True, **vkw), mesh=mesh,
                               nshards=n_devices)
        _check(r2.steps == 2 and np.all(np.isfinite(host64(r2.xopt))),
               f"transpose reduction {vkw}")
    out["transpose_reduction"] = "2 steps, finite (plain, fast, relax 1.5)"

    n_sl = 4 * n_devices + 3  # not divisible: uneven slices
    lengths = slicemaker(0, n_sl, n_devices)
    starts = np.concatenate([[0], np.cumsum(lengths)[:-1]])
    L = max(lengths)

    def prox_slice(x, z, u, rho, k):
        v = torch.nn.functional.pad(z - u, (0, L))
        return v[int(starts[k]):int(starts[k]) + L] * rho

    prox = make_sliced_prox(prox_slice, lengths, mesh)
    zv, uv = t(rng.standard_normal(n_sl)), t(rng.standard_normal(n_sl))
    _check(torch.equal(prox(zv, zv, uv, 1.5), 1.5 * (zv - uv)), "sliced prox not exact")

    res_en = consensus_elasticnet(t(D), t(s), lam, 0.6, ADMMConfig(maxiters=100), mesh=mesh,
                                  nshards=n_devices)
    _check(np.all(np.isfinite(host64(res_en.zopt))), "consensus elastic net not finite")

    W = n_devices
    setup = ls_setup(mesh.take(shard_rows(pad_rows(t(D), W)[0], W)),
                     mesh.take(shard_rows(pad_rows(t(s), W)[0], W)), False, 1.0)
    dsolve = make_implicit_consensus_solver(
        _lasso_local_prox, _lasso_global_prox,
        ADMMConfig(maxiters=500, abstol=1e-8, reltol=1e-8), cols, W, mesh=mesh)
    g = torch.func.grad(lambda lm: torch.sum(dsolve(dict(setup, lam=lm))[1] ** 2))(
        torch.tensor(lam, device=dev))
    _check(bool(torch.isfinite(g)), "sharded hypergradient not finite")
    out["hypergradient"] = float(g)

    if len(mesh.axis_names) == 1:
        Bn = 2 * n_devices
        Sb = (rng.standard_normal((Bn, rows)) * 0.5).astype(np.float32)
        cfgb = ADMMConfig(maxiters=100)
        plain = lasso_batch(t(D), t(Sb), lam, cfgb)
        sharded = lasso_batch(t(D), t(Sb), lam, cfgb, mesh=mesh)
        _check(np.abs(host64(sharded.xopt) - host64(plain.xopt)).max() <= 1e-10
               and torch.equal(sharded.steps.cpu(), plain.steps.cpu()),
               "sharded lanes differ from the plain lanes")

    As = rng.standard_normal((n_devices, 12, 6)).astype(np.float32)
    bs = rng.standard_normal((n_devices, 12)).astype(np.float32)
    rex = exchange_quadratic(t(As), t(bs), ADMMConfig(maxiters=3000, abstol=1e-6, reltol=1e-6),
                             mesh=mesh)
    Ginv = np.stack([np.linalg.inv(A.T.astype(np.float64) @ A.astype(np.float64)) for A in As])
    Atb = np.einsum("wmi,wm->wi", As.astype(np.float64), bs.astype(np.float64))
    nu = np.linalg.solve(Ginv.sum(0), np.einsum("wij,wj->i", Ginv, Atb))
    xeq = np.einsum("wij,wj->wi", Ginv, Atb - nu[None, :])
    xex = host64(rex.xopt)
    _check(np.abs(xex - xeq).max() <= 1e-3 and np.linalg.norm(xex.sum(0)) <= 1e-3,
           "exchange off its equilibrium")
    out["exchange"] = dict(steps=int(rex.steps), max_dev=float(np.abs(xex - xeq).max()))

    # The SDP in float64 at admm_tpu's two-process bar (1e-8, equal steps):
    # in float32 the sharded and serial contractions round apart enough to
    # move the stop by a step.
    Cs_, As_, bs_, _, _, _ = random_sdp_instance(8, 2 * n_devices, 3, rng)
    t64 = lambda a: torch.as_tensor(np.asarray(a, np.float64), device=dev)  # noqa: E731
    cfg_sdp = ADMMConfig(maxiters=500, abstol=1e-5, reltol=1e-5)
    r_ser = sdp(t64(Cs_), t64(As_), t64(bs_), config=cfg_sdp)
    r_sh = sdp_sharded(t64(Cs_), t64(As_), t64(bs_), config=cfg_sdp, mesh=mesh)
    dz = np.abs(host64(r_sh.zopt) - host64(r_ser.zopt)).max()
    _check(dz < 1e-8 and int(r_sh.steps) == int(r_ser.steps),
           f"sharded SDP ({int(r_sh.steps)} steps) {dz} from the serial "
           f"({int(r_ser.steps)} steps)")
    out["sdp"] = dict(steps=int(r_sh.steps), max_dev=float(dz))

    Dcv = rng.standard_normal((16 * n_devices, 8)).astype(np.float32)
    cfg_cv = ADMMConfig(maxiters=2000, abstol=1e-6, reltol=1e-6)
    r_cser = covarianceselection(t(Dcv), 0.1, cfg_cv)
    r_ccon = consensus_covsel(t(Dcv), 0.1, cfg_cv, mesh=mesh)
    dS = {"S": empirical_covariance(t(Dcv)), "lam": torch.tensor(0.1, device=dev)}
    f_cs = float(covsel_obj(r_cser.xopt, r_cser.zopt, dS))
    f_cc = float(covsel_obj(r_ccon.xopt, r_ccon.zopt, dS))
    _check(abs(f_cc - f_cs) <= 1e-3 * (1.0 + abs(f_cs)), f"covsel {f_cc} vs {f_cs}")
    out["covsel"] = dict(steps=int(r_ccon.steps), objective=f_cc, serial=f_cs)
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--devices", type=int, default=8)
    ap.add_argument("--device", default=None)
    a = ap.parse_args(argv)
    print(json.dumps(dryrun(a.devices, device=a.device)))


if __name__ == "__main__":
    main()
