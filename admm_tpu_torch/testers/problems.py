"""Per-problem randomized oracle testers (port of
``admm_tpu/testers/problems.py``).

Each mirrors the matching reference tester's construction, oracle and
pass criterion (testers/<name>test.m; SURVEY.md section 4), with the same
numpy draws as ``admm_tpu``'s, so a seed gives both packages the same
instance.  Common contract (e.g. testers/modeltest.m:37-38):

    results, test = <name>test(seed, rows, cols, errtol, quiet=True,
                               config=ADMMConfig(), device=None,
                               dtype=torch.float64, **overrides)

``test`` carries the instance, the oracle values, ``failed`` and
``failreason``.  The instance is drawn in float64 with numpy and handed to
the solver in ``dtype`` on ``device`` (the card unless the caller asks for
the CPU, ``device.resolve_device``); the oracle values are computed on the
host in float64 from the solver's results.
"""

from __future__ import annotations

import numpy as np
import torch

from ..config import ADMMConfig
from ..models import (
    basispursuit,
    covarianceselection,
    huberfit,
    lad,
    lasso,
    linearprogram,
    linearsvm,
    model,
    quadraticprogram,
    totalvariation,
)
from ..models._common import host64, merge_config


def _in(dtype, *arrays):
    """The instance's float64 arrays as numpy arrays of ``dtype``'s
    precision (the solver places them on its device)."""
    np_dtype = torch.empty(0, dtype=dtype).numpy().dtype
    out = tuple(np.asarray(a, dtype=np_dtype) for a in arrays)
    return out[0] if len(out) == 1 else out


def _report(quiet, test, results):
    if not quiet:
        from ..utils.report import showresults

        showresults(results, test)
    return results, test


def modeltest(seed=0, rows=128, cols=128, errtol=1e-3, quiet=True,
              config=ADMMConfig(), device=None, dtype=torch.float64,
              **overrides):
    """Closed-form oracle x* = (P'P+Q'Q)^{-1}(P'r+Q's)
    (testers/modeltest.m:114-177)."""
    # Tighter-than-default stopping: the oracle demands an ABSOLUTE
    # x-residual <= errtol, which the engine's default Boyd tolerances
    # only marginally reach on ill-conditioned random squares.
    cfg = merge_config(config, dict(
        objevals=overrides.pop("objevals", True),
        maxiters=overrides.pop("maxiters", 10000),
        abstol=overrides.pop("abstol", 1e-7),
        reltol=overrides.pop("reltol", 1e-5),
        convtest=overrides.pop("convtest", True),
        stopcond=overrides.pop("stopcond", "both"), **overrides))
    rng = np.random.default_rng(seed)
    P, Q = rng.standard_normal((rows, cols)), rng.standard_normal((rows, cols))
    r, s = rng.standard_normal(rows), rng.standard_normal(rows)
    truex = np.linalg.solve(P.T @ P + Q.T @ Q, P.T @ r + Q.T @ s)
    trueobj = 0.5 * np.sum((P @ truex - r) ** 2) + 0.5 * np.sum((Q @ truex - s) ** 2)

    results = model(*_in(dtype, P, Q, r, s), cfg, device=device)
    xopt = host64(results.xopt)
    objopt = 0.5 * np.sum((P @ xopt - r) ** 2) + 0.5 * np.sum((Q @ xopt - s) ** 2)
    objerror = abs(1.0 - objopt / trueobj)
    xresidual = float(np.linalg.norm(truex - xopt))

    ok_obj, ok_x = objerror <= errtol, xresidual <= errtol
    failed = not (ok_obj and ok_x)
    # 4-way failure diagnosis (modeltest.m:156-177).
    if not failed:
        reason = "objective and x residual within tolerance"
    elif ok_x:
        reason = f"objective rel-err {objerror:.3g} > {errtol}"
    elif ok_obj:
        reason = f"x residual {xresidual:.3g} > {errtol}"
    else:
        reason = "both objective rel-err and x residual exceed tolerance"
    test = dict(solver="model", seed=seed, truexopt=truex, trueobjopt=trueobj,
                objopt=objopt, xresidual=xresidual, failed=failed,
                failreason=reason)
    return _report(quiet, test, results)


def lassotest(seed=0, rows=256, cols=128, errtol=1e-3, quiet=True,
              config=ADMMConfig(), device=None, dtype=torch.float64,
              **overrides):
    """Sparse planted signal; ADMM objective must beat the planted one
    (testers/lassotest.m:109-147)."""
    cfg = merge_config(config, dict(
        objevals=overrides.pop("objevals", True), **overrides))
    rng = np.random.default_rng(seed)
    testx = rng.standard_normal(cols) * (rng.random(cols) < 0.6)
    D = rng.standard_normal((rows, cols))
    D = D / np.sqrt(np.sum(D**2, axis=0, keepdims=True))
    s = D @ testx + np.sqrt(0.001) * rng.standard_normal(rows)
    lam = 0.1 * np.max(np.abs(D.T @ s))

    def obj(x, z):
        return 0.5 * np.sum((D @ x - s) ** 2) + lam * np.sum(np.abs(z))

    results = lasso(*_in(dtype, D, s), lam, cfg, device=device)
    xopt = host64(results.xopt)
    failed = not (obj(xopt, xopt) < obj(testx, testx))
    test = dict(solver="lasso", seed=seed, truexopt=testx,
                testobj=obj(testx, testx), objopt=obj(xopt, xopt),
                failed=failed,
                failreason="" if not failed else "objective did not beat planted point")
    return _report(quiet, test, results)


def basispursuittest(seed=0, rows=32, cols=128, errtol=1e-10, quiet=True,
                     config=ADMMConfig(), device=None, dtype=torch.float64,
                     **overrides):
    """Planted sparse x with s = D x (testers/basispursuittest.m:109-143)."""
    cfg = merge_config(config, dict(
        objevals=overrides.pop("objevals", True),
        maxiters=overrides.pop("maxiters", 10000),
        abstol=overrides.pop("abstol", 1e-9),
        reltol=overrides.pop("reltol", 1e-8), **overrides))
    rng = np.random.default_rng(seed)
    D = rng.standard_normal((rows, cols))
    # Plant a guaranteed-nonzero sparse x (an all-zero plant makes the
    # relerror denominator 0/0 and spuriously fails the trial).
    testx = np.zeros(cols)
    idx = rng.choice(cols, size=max(1, int(round(0.1 * cols))), replace=False)
    testx[idx] = rng.standard_normal(len(idx))
    s = D @ testx
    testobj = np.sum(np.abs(testx))

    results = basispursuit(*_in(dtype, D, s), cfg, device=device)
    xopt = host64(results.xopt)
    objopt = np.sum(np.abs(xopt))
    Dx = D @ xopt
    relerror = float(np.mean(np.abs((Dx - s) / Dx)))
    # Relative slack on the objective comparison: the solver legitimately
    # lands within solver tolerance of (or exactly on) the planted point.
    failed = not (objopt <= testobj * (1 + 1e-6) + 1e-8 and relerror <= errtol)
    test = dict(solver="basispursuit", seed=seed, truexopt=testx,
                testobj=testobj, objopt=objopt, relerror=relerror,
                failed=failed,
                failreason="" if not failed else
                f"objective {objopt:.3g} vs planted {testobj:.3g}, relerror {relerror:.3g}")
    return _report(quiet, test, results)


def totalvariationtest(seed=0, rows=256, cols=None, errtol=0.02, quiet=True,
                       config=ADMMConfig(), lam=1.0, device=None,
                       dtype=torch.float64, **overrides):
    """Staircase signal + noise (testers/totalvariationtest.m:109-155)."""
    cfg = merge_config(config, dict(
        objevals=overrides.pop("objevals", True),
        maxiters=overrides.pop("maxiters", 10000), **overrides))
    rng = np.random.default_rng(seed)
    truex = np.ones(rows)
    for _ in range(3):
        rs_ = int(rng.integers(1, rows + 1))
        ri = int(rng.integers(1, 11))
        truex[int(np.ceil(rs_ / 2)) - 1 : rs_] *= ri
    s = truex + rng.standard_normal(rows)

    def objective(x):
        return 0.5 * np.sum((x - s) ** 2) + lam * np.sum(np.abs(np.diff(x)))

    results = totalvariation(_in(dtype, s), lam, cfg, device=device)
    xopt = host64(results.xopt)
    failed = not (objective(xopt) < objective(truex))
    test = dict(solver="totalvariation", seed=seed, truexopt=truex, s=s,
                trueobjopt=objective(truex), objopt=objective(xopt),
                failed=failed,
                failreason="" if not failed else "objective did not beat true signal")
    return _report(quiet, test, results)


def ladtest(seed=0, rows=512, cols=32, errtol=1e-3, quiet=True,
            config=ADMMConfig(), device=None, dtype=torch.float64,
            **overrides):
    """Planted x + huge sparse outliers (testers/ladtest.m:115-168)."""
    cfg = merge_config(config, dict(
        objevals=overrides.pop("objevals", True),
        convtest=overrides.pop("convtest", True), **overrides))
    rng = np.random.default_rng(seed)
    D = rng.standard_normal((rows, cols))
    xtrue = 10.0 * rng.standard_normal(cols)
    s = D @ xtrue
    idx = rng.choice(rows, size=int(np.ceil(rows / 50)), replace=False)
    s[idx] = s[idx] + 100.0 * rng.standard_normal(len(idx))
    trueobj = np.sum(np.abs(D @ xtrue - s))

    results = lad(*_in(dtype, D, s), cfg, device=device)
    xopt = host64(results.xopt)
    objopt = np.sum(np.abs(D @ xopt - s))
    xresidual = float(np.linalg.norm(xtrue - xopt))
    ok_x = xresidual < errtol
    ok_obj = abs(objopt - trueobj) <= errtol * trueobj
    failed = not (ok_x and ok_obj)
    test = dict(solver="lad", seed=seed, truexopt=xtrue, trueobjopt=trueobj,
                objopt=objopt, xresidual=xresidual, failed=failed,
                failreason="" if not failed else
                f"x residual {xresidual:.3g} (tol {errtol}), obj rel gap "
                f"{abs(objopt - trueobj) / trueobj:.3g}")
    return _report(quiet, test, results)


def huberfittest(seed=0, rows=512, cols=32, errtol=1e-3, quiet=True,
                 config=ADMMConfig(), device=None, dtype=torch.float64,
                 **overrides):
    """Planted solution + Gaussian + sparse large noise
    (testers/huberfittest.m:121-158)."""
    from ..models.huberfit import huber_loss

    cfg = merge_config(config, dict(
        objevals=overrides.pop("objevals", True),
        convtest=overrides.pop("convtest", True), **overrides))
    rng = np.random.default_rng(seed)
    testx = rng.standard_normal(cols)
    D = rng.standard_normal((rows, cols))
    D = D / np.sqrt(np.sum(D**2, axis=0, keepdims=True))
    s = D @ testx + np.sqrt(0.01) * rng.standard_normal(rows)
    density = min(1.0, 200.0 / rows)
    s = s + 10.0 * rng.random(rows) * (rng.random(rows) < density)

    def obj(v):
        return float(torch.sum(huber_loss(torch.from_numpy(np.asarray(v, np.float64)))))

    results = huberfit(*_in(dtype, D, s), cfg, device=device)
    xopt = host64(results.xopt)
    failed = not (obj(D @ xopt - s) < obj(D @ testx - s))
    test = dict(solver="huberfit", seed=seed, truexopt=testx,
                trueobjopt=obj(D @ testx - s), objopt=obj(D @ xopt - s),
                failed=failed,
                failreason="" if not failed else "objective did not beat planted point")
    return _report(quiet, test, results)


def linearprogramtest(seed=0, rows=64, cols=64, errtol=1e-10, quiet=True,
                      config=ADMMConfig(), device=None, dtype=torch.float64,
                      **overrides):
    """Square full-rank D with nonnegative planted x: unique feasible point
    (testers/linearprogramtest.m:108-138)."""
    cfg = merge_config(config, dict(
        objevals=overrides.pop("objevals", True),
        maxiters=overrides.pop("maxiters", 10000),
        abstol=overrides.pop("abstol", 1e-11),
        reltol=overrides.pop("reltol", 1e-9), **overrides))
    rng = np.random.default_rng(seed)
    n = cols
    b = rng.random(n) + 0.5
    truex = np.abs(rng.standard_normal(n))
    D = np.abs(rng.standard_normal((rows, n)))
    s = D @ truex
    trueobj = float(b @ truex)

    results = linearprogram(*_in(dtype, b, D, s), cfg, device=device)
    xopt = host64(results.xopt)
    objopt = float(b @ xopt)
    Dx = D @ xopt
    relerror = float(np.mean(np.abs((Dx - s) / Dx)))
    failed = not (abs((trueobj - objopt) / objopt) <= errtol and relerror <= errtol)
    test = dict(solver="linearprogram", seed=seed, truexopt=truex,
                trueobjopt=trueobj, objopt=objopt, relerror=relerror,
                failed=failed,
                failreason="" if not failed else
                f"obj rel gap {abs((trueobj - objopt) / objopt):.3g}, relerror {relerror:.3g}")
    return _report(quiet, test, results)


def quadraticprogramtest(seed=0, rows=48, cols=48, errtol=1e-5, quiet=True,
                         config=ADMMConfig(), form="standard", device=None,
                         dtype=torch.float64, **overrides):
    """Well-conditioned PD P (testers/quadraticprogramtest.m:133-138);
    standard form uses a unique-feasible-point oracle, bounded form an
    interior-optimum oracle."""
    cfg = merge_config(config, dict(
        objevals=overrides.pop("objevals", True),
        maxiters=overrides.pop("maxiters", 10000),
        abstol=overrides.pop("abstol", 1e-11),
        reltol=overrides.pop("reltol", 1e-9), **overrides))
    rng = np.random.default_rng(seed)
    n = cols
    Praw = rng.random((n, n))
    Praw = Praw + Praw.T
    Qv = np.linalg.eigh(Praw)[1]
    P = (Qv * (1.0 + rng.random(n))) @ Qv.T
    q = rng.standard_normal(n)
    r = float(rng.standard_normal())

    if form == "standard":
        truex = np.abs(rng.standard_normal(n))
        D = np.abs(rng.standard_normal((rows, n)))
        s = D @ truex
        results = quadraticprogram(*_in(dtype, P, q), r, *_in(dtype, D, s), cfg, device=device)
        xopt = host64(results.xopt)
        xres = float(np.linalg.norm(xopt - truex))
        failed = not (xres <= errtol and np.linalg.norm(D @ xopt - s) <= errtol)
        test = dict(solver="quadraticprogram", form=form, seed=seed,
                    truexopt=truex, xresidual=xres, failed=failed,
                    failreason="" if not failed else f"x residual {xres:.3g}")
    else:
        xstar = -np.linalg.solve(P, q)
        lb = xstar - 1.0 - rng.random(n)
        ub = xstar + 1.0 + rng.random(n)
        results = quadraticprogram(*_in(dtype, P, q), r, *_in(dtype, lb, ub), cfg,
                                   device=device)
        xopt = host64(results.xopt)
        xres = float(np.linalg.norm(xopt - xstar))
        failed = not (xres <= errtol)
        test = dict(solver="quadraticprogram", form=form, seed=seed,
                    truexopt=xstar, xresidual=xres, failed=failed,
                    failreason="" if not failed else f"x residual {xres:.3g}")
    return _report(quiet, test, results)


def covarianceselectiontest(seed=0, rows=256, cols=32, errtol=1e-3, quiet=True,
                            config=ADMMConfig(), lam=1.0, prox_method="eigh",
                            device=None, dtype=torch.float64, **overrides):
    """Sparse SPD inverse covariance, Gaussian samples
    (testers/covarianceselectiontest.m:112-154).

    ``prox_method`` selects the x-prox evaluation ('eigh' exact /
    'ns' Newton-Schulz TPU mode) so the on-device accuracy sweep can
    certify both."""
    cfg = merge_config(config, dict(
        objevals=overrides.pop("objevals", True),
        maxiters=overrides.pop("maxiters", 1000),
        convtest=overrides.pop("convtest", True), **overrides))
    rng = np.random.default_rng(seed)
    Sinv = np.diag(np.ones(cols))
    k = int(np.ceil(0.001 * cols * cols)) + 2
    idx = rng.choice(cols * cols, size=k, replace=False)
    Sinv.flat[idx] = 1.0
    Sinv = Sinv + Sinv.T
    w = np.linalg.eigvalsh(Sinv)
    if w.min() < 0:
        Sinv = Sinv + 1.1 * abs(w.min()) * np.eye(cols)
    S_true = np.linalg.inv(Sinv)
    D = rng.multivariate_normal(np.zeros(cols), S_true, size=rows)

    from ..models.covarianceselection import empirical_covariance

    S = empirical_covariance(torch.from_numpy(D)).numpy()

    def obj(X, Z):
        return float(np.trace(S @ X) - np.linalg.slogdet(X)[1] + lam * np.sum(np.abs(Z)))

    results = covarianceselection(_in(dtype, D), lam, cfg, prox_method=prox_method,
                                  device=device)
    X = host64(results.xopt)
    failed = not (obj(X, X) < obj(Sinv, Sinv))
    test = dict(solver="covarianceselection", seed=seed, truexopt=Sinv,
                trueobjopt=obj(Sinv, Sinv), objopt=obj(X, X), failed=failed,
                failreason="" if not failed else "objective did not beat truth")
    return _report(quiet, test, results)



def make_svm_instance(seed, mpos=128, mneg=128, sep=0.5):
    """Linearly separable 2-D classes around the x1 = x2 line with
    margin ``sep`` (the linearsvmtest construction,
    testers/linearsvmtest.m:130-146).  Shared by the tester, the
    unwrapped-ADMM example, and any benchmark needing SVM data."""
    rng = np.random.default_rng(seed)
    bp, bn = np.linspace(0, 2, mpos), np.linspace(0, 2, mneg)
    pos = np.stack([bp + rng.random(mpos) - sep * rng.random(mpos),
                    bp - rng.random(mpos) + sep * rng.random(mpos)], 1)
    neg = np.stack([bn - rng.random(mneg) + sep * rng.random(mneg),
                    bn + rng.random(mneg) - sep * rng.random(mneg)], 1)
    D = np.concatenate([pos, neg])
    ell = np.concatenate([np.ones(mpos), -np.ones(mneg)])
    return D, ell


def linearsvmtest(seed=0, mpos=128, mneg=128, sep=0.5, errtol=0.05, quiet=True,
                  config=ADMMConfig(), C=1.0, errtol01=None, parallel=False,
                  nshards=None, device=None, dtype=torch.float64, **overrides):
    """Separable 2-D classes around x1 = x2; runs BOTH hinge and 0-1 loss
    (testers/linearsvmtest.m:130-255).  Returns (results_hinge,
    results_01, test).

    ``errtol01`` (default 2.5*errtol): the nonconvex 0-1 heuristic's
    slope scatter is ~2.5x the convex hinge solve's, so it gets its own
    bar.  ``parallel=True`` routes both solves through the sharded
    transpose-reduction path (the reference's options.parallel through
    solvertester, unwrappedadmmtest.m:41-58), with the rows in ``nshards``
    shards (default: the mesh size, ``parallel.make_mesh``).
    """
    if errtol01 is None:
        errtol01 = 2.5 * errtol
    cfg = merge_config(config, dict(
        objevals=overrides.pop("objevals", True),
        maxiters=overrides.pop("maxiters", 1000), **overrides))
    D, ell = make_svm_instance(seed, mpos, mneg, sep)

    def obj(x, loss):
        v = ell * (D @ x)
        t = np.maximum(np.sign(1 - v), 0) if loss == "01" else np.maximum(1 - v, 0)
        return 0.5 * np.sum(x * x) + C * np.sum(t)

    Dd, elld = _in(dtype, D, ell)
    kw = dict(parallel=parallel, nshards=nshards, seed=seed, device=device)
    res_h = linearsvm(Dd, elld, C, cfg, loss="hinge", **kw)
    res_01 = linearsvm(Dd, elld, C, cfg, loss="01", **kw)
    xh, x01 = host64(res_h.xopt), host64(res_01.xopt)
    relerr_h = abs(1.0 - (-xh[1] / xh[0]))
    relerr_01 = abs(1.0 - (-x01[1] / x01[0]))
    trueobj_h = obj(np.array([1.0, -1.0]), "hinge")
    trueobj_01 = obj(np.array([1.0, -1.0]), "01")
    failed_h = not (obj(xh, "hinge") < trueobj_h and relerr_h <= errtol)
    failed_01 = not (obj(x01, "01") < trueobj_01 and relerr_01 <= errtol01)
    test = dict(solver="linearsvm", seed=seed, relerr_hinge=relerr_h,
                relerr_01=relerr_01, failed=failed_h or failed_01,
                failed_hinge=failed_h, failed_01=failed_01,
                failreason="" if not (failed_h or failed_01) else
                f"hinge relerr {relerr_h:.3g}, 0-1 relerr {relerr_01:.3g}")
    if not quiet:
        from ..utils.report import showresults

        showresults(res_h, test)
    return res_h, res_01, test


def logregtest(seed=0, rows=256, cols=24, errtol=1e-3, quiet=True,
               config=ADMMConfig(), lam=None, inner="newton", device=None,
               dtype=torch.float64, **overrides):
    """Sparse logistic regression oracle (beyond reference — no MATLAB
    counterpart; construction mirrors the library's randomized style):
    labels drawn from a planted logistic model, solved at l1 weight
    ``lam`` (default 0.1 * ||grad at 0||_inf), checked by the exact KKT
    subgradient conditions of the nonsmooth optimum —
    |g_j + lam sign(z_j)| <= errtol on the active set and
    |g_j| <= lam + errtol on the zeros, g the smooth logistic gradient.
    """
    from ..models.logreg import logreg

    cfg = merge_config(config, dict(
        objevals=overrides.pop("objevals", True),
        maxiters=overrides.pop("maxiters", 2000),
        abstol=overrides.pop("abstol", 1e-8),
        reltol=overrides.pop("reltol", 1e-7), **overrides))
    rng = np.random.default_rng(seed)
    D = rng.standard_normal((rows, cols))
    wtrue = rng.standard_normal(cols) * (rng.random(cols) < 0.5)
    p = 1.0 / (1.0 + np.exp(-(D @ wtrue)))
    ell = np.where(rng.random(rows) < p, 1.0, -1.0)
    Y = D * ell[:, None]
    if lam is None:
        g0 = -Y.T @ np.full(rows, 0.5)  # smooth gradient at x = 0
        lam = 0.1 * float(np.max(np.abs(g0)))

    results = logreg(*_in(dtype, D, ell), lam, cfg, inner=inner, device=device)
    z = host64(results.zopt)
    sig = 1.0 / (1.0 + np.exp(Y @ z))   # sigmoid(-Yz)
    g = -Y.T @ sig
    act = np.abs(z) > 1e-8
    kkt_act = (float(np.max(np.abs(g[act] + lam * np.sign(z[act]))))
               if act.any() else 0.0)
    kkt_zero = (float(max(np.max(np.abs(g[~act])) - lam, 0.0))
                if (~act).any() else 0.0)
    kkt = max(kkt_act, kkt_zero)
    failed = not (kkt <= errtol)
    test = dict(solver="logreg", seed=seed, lam=lam, kkt=kkt,
                truexopt=wtrue, objopt=results.objopt, failed=failed,
                failreason="" if not failed else f"KKT residual {kkt:.3g}")
    return _report(quiet, test, results)
