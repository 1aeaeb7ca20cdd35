"""Accuracy and time of the routes to a float32 symmetric eigendecomposition
on the card, for the spectral proxes of covariance selection and the SDP.

torch's ``linalg.eigh`` takes cuSOLVER's Jacobi ``syevj`` for a float32
matrix of order 32 to 512 and ``syevd`` otherwise.  The probe holds each
route against float64 ``syevd`` on the same inputs:

- ``syevj``: ``torch.linalg.eigh`` on the float32 matrix (torch's choice);
- ``syevd``: the float32 matrix bordered to order 513 by an eigenvalue
  above its spectrum (so torch takes ``syevd``), the border dropped after;
- ``f64``: the float32 matrix decomposed in float64, the factors rounded
  back to float32 (``ops/prox.sym_eigh``'s route on the card);
- ``lapack``: LAPACK's float32 ``syevd`` on the host;
- ``bf16 input``: the matrix rounded to bfloat16 first (a coarse control);
- ``ns``: ``ops/matfun.psd_project_ns`` (16 steps) in float32 against the
  same in float64, for the SDP's matrices.

Per call, on matrices W taken from float64 runs (the max-cut SDP n = 512
after 1, 10 and 40 steps, the dense SDP ``random_sdp_instance(128, 512,
32)`` after 10 and 100, covariance selection n = 256 and 512 after 10):
the prox's error against float64, ||Q diag(e) Q^T - W|| / ||W||,
max |Q^T Q - I| and the time per call (CUDA events around 20 calls, each
with its host read of cuSOLVER's info).  Then whole runs: each route's
float32 solve after the same steps against float64 (``ops/prox.sym_eigh``
swapped for the route), and converging runs (syevj, the f64 route, the
float64 solve, Newton-Schulz) with their certified max-cut gap (a
feasible primal point from Z, a dual bound from U) and the dense SDP's
gap to its known optimum.

Run: ``python -m admm_tpu_torch.experiments.eigh_route_probe`` (a CUDA
device; ``--smoke --device cpu`` for a small run on the host).
"""

import argparse
import time

import numpy as np
import torch

from .. import ADMMConfig, covarianceselection, sdp
from ..models.covarianceselection import empirical_covariance
from ..models.sdp import random_sdp_instance
from ..ops import prox
from ..ops.matfun import psd_project_ns
from ..ops.prox import _sym

SYEVJ_MAX = 512  # torch takes syevj for float32 up to this order


def eigh_syevj(W):
    return torch.linalg.eigh(_sym(W))


def eigh_syevd(W):
    """float32 syevd: the matrix bordered past SYEVJ_MAX by an isolated
    eigenvalue above its spectrum, which sorts last and is dropped."""
    W = _sym(W)
    n = W.shape[-1]
    N = max(n, SYEVJ_MAX + 1)
    if N == n:
        return torch.linalg.eigh(W)
    top = torch.amax(torch.sum(torch.abs(W), dim=-1), dim=-1) + 1.0
    Wp = torch.zeros(W.shape[:-2] + (N, N), dtype=W.dtype, device=W.device)
    Wp[..., :n, :n] = W
    idx = torch.arange(n, N, device=W.device)
    Wp[..., idx, idx] = top[..., None]
    e, Q = torch.linalg.eigh(Wp)
    return e[..., :n], Q[..., :n, :n]


def eigh_f64(W):
    e, Q = torch.linalg.eigh(_sym(W).double())
    return e.to(W.dtype), Q.to(W.dtype)


ROUTES = {"syevj": eigh_syevj, "syevd": eigh_syevd, "f64": eigh_f64}


def rel(a, b):
    return float(torch.linalg.norm(a.double() - b.double()) / torch.linalg.norm(b.double()))


def decomposition_errors(route, W32):
    e, Q = route(W32)
    e, Q = e.double(), Q.double()
    W = _sym(W32).double()
    resid = rel((Q * e.unsqueeze(-2)) @ Q.T, W)
    orth = float(torch.max(torch.abs(Q.T @ Q - torch.eye(Q.shape[-1], dtype=Q.dtype,
                                                          device=Q.device))))
    return resid, orth


def ms_per_call(fn, reps=20):
    if not fn().is_cuda:
        t = time.perf_counter()
        for _ in range(reps):
            fn()
        return (time.perf_counter() - t) * 1e3 / reps
    start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def with_route(route, solve):
    saved = prox.sym_eigh
    prox.sym_eigh = route
    try:
        return solve()
    finally:
        prox.sym_eigh = saved


def project_with(route, W):
    return with_route(route, lambda: prox.psd_project(W))


def covsel_with(route, W, rho):
    return with_route(route, lambda: prox.covsel_eig_prox(W, rho))


def maxcut_gap(C, r, rho):
    """(relative gap, primal bound, dual bound) of a max-cut SDP iterate:
    Z scaled to unit diagonal is feasible; any y gives the dual bound
    1^T y + n lambda_min(C - Diag y), with y = diag(C -+ rho U)."""
    C, Z, U = (v.double() for v in (C, r.zopt, r.uopt))
    s = torch.rsqrt(torch.clamp_min(torch.diagonal(Z), 1e-300))
    ub = float(torch.sum(C * (s[:, None] * Z * s[None, :])))
    lb = -np.inf
    for sign in (1.0, -1.0):
        y = torch.diagonal(C - sign * rho * U)
        lam = torch.linalg.eigvalsh(C - torch.diag(y))[0]
        lb = max(lb, float(torch.sum(y) + C.shape[0] * lam))
    return (ub - lb) / max(1.0, abs(ub)), ub, lb


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None)
    ap.add_argument("--smoke", action="store_true", help="small sizes")
    args = ap.parse_args()
    dev = torch.device(args.device or ("cuda" if torch.cuda.is_available() else "cpu"))
    if dev.type == "cuda":
        print(f"device: {torch.cuda.get_device_name(dev)}; torch {torch.__version__}")
    sc = 8 if args.smoke else 1
    n_mc, (n_d, m_d, r_d), n_cs = 512 // sc, (128 // sc, 512 // sc, 32 // sc), 512 // sc
    steps_mc, steps_d = (40, 100)
    rng = np.random.default_rng(0)

    # Instances: the max-cut SDP (10% edges), the dense SDP, covariance selection.
    adj = np.triu(rng.random((n_mc, n_mc)) < 0.1, 1).astype(np.float64)
    adj = adj + adj.T
    Cmc = torch.from_numpy(-0.25 * (np.diag(adj.sum(-1)) - adj)).float().to(dev)
    ones = torch.ones(n_mc, device=dev)
    Cd, Ad, bd, Xs, *_ = random_sdp_instance(n_d, m_d, r_d, rng, dtype=np.float32)
    pstar = float(np.sum(Cd.astype(np.float64) * Xs.astype(np.float64)))
    Cd, Ad, bd = (torch.from_numpy(a).to(dev) for a in (Cd, Ad, bd))
    covsel_D = {n: torch.from_numpy(rng.standard_normal((4 * n, n)).astype(np.float32)).to(dev)
                for n in (n_cs // 2, n_cs)}

    def run_mc(dt, steps, **kw):
        return sdp(Cmc.to(dt), "diag", ones.to(dt),
                   ADMMConfig(maxiters=steps, domaxiters=True), **kw)

    def run_d(dt, steps, **kw):
        return sdp(Cd.to(dt), Ad.to(dt), bd.to(dt),
                   ADMMConfig(maxiters=steps, domaxiters=True), **kw)

    # The prox inputs, from float64 runs.
    cases = []
    for k in (1, 10, steps_mc):
        r = run_mc(torch.float64, k)
        cases.append((f"max-cut n={n_mc} step {k}", "psd", r.xopt + r.uopt))
    for k in (10, steps_d):
        r = run_d(torch.float64, k)
        cases.append((f"dense n={n_d} m={m_d} step {k}", "psd", r.xopt + r.uopt))
    for n, D in covsel_D.items():
        r = covarianceselection(D.double(), 0.1, ADMMConfig(maxiters=10, domaxiters=True))
        S = empirical_covariance(D.double())
        cases.append((f"covsel n={n} step 10", "covsel", (r.zopt - r.uopt) - S))

    print("per call: prox error against float64 | ||Q e Q^T - W|| / ||W|| | "
          "max|Q^T Q - I| | ms per call")
    for name, kind, W64 in cases:
        W32 = W64.float()
        if kind == "psd":
            ref = prox.psd_project(W64)
            apply = project_with
        else:
            ref = prox.covsel_eig_prox(W64, 1.0)
            apply = lambda route, W: covsel_with(route, W, 1.0)  # noqa: E731
        print(f"  {name}:")
        for rname, route in ROUTES.items():
            err = rel(apply(route, W32), ref)
            resid, orth = decomposition_errors(route, W32)
            ms = ms_per_call(lambda: apply(route, W32))
            print(f"    {rname:6s} {err:.3e} | {resid:.3e} | {orth:.3e} | {ms:.3f} ms")
        err = rel(apply(eigh_syevj, W32.cpu()), ref.cpu())
        resid, orth = decomposition_errors(eigh_syevj, W32.cpu())
        print(f"    lapack {err:.3e} | {resid:.3e} | {orth:.3e} | (host)")
        Wb = W64.to(torch.bfloat16).double()
        print(f"    bf16 input (float64 eigh) {rel(apply(eigh_syevj, Wb), ref):.3e}")
        if kind == "psd":
            err = rel(psd_project_ns(W32, 16), psd_project_ns(W64, 16))
            ms = ms_per_call(lambda: psd_project_ns(W32, 16))
            print(f"    ns16 (against ns16 in float64) {err:.3e} | {ms:.3f} ms")

    print("whole runs, the same steps: ||Z_f32 - Z_f64|| / ||Z_f64||, <C, Z> f32 / f64, s")
    for label, run, steps, C in (("max-cut", run_mc, steps_mc, Cmc), ("dense", run_d, steps_d, Cd)):
        ref = run(torch.float64, steps)
        obj64 = float(torch.sum(C.double() * ref.zopt))
        for rname, route in list(ROUTES.items()) + [("lapack", eigh_syevj)]:
            t = time.perf_counter()
            if rname == "lapack":
                r = run(torch.float32, steps, device="cpu")
            else:
                r = with_route(route, lambda: run(torch.float32, steps))
            dt = time.perf_counter() - t
            print(f"  {label} {steps} steps {rname:6s} {rel(r.zopt.to(dev), ref.zopt):.3e}, "
                  f"{float(torch.sum(C.double().cpu() * r.zopt.double().cpu())):.6f} / "
                  f"{obj64:.6f}, {dt:.2f} s")
        r = run(torch.float32, steps, prox_method="ns", ns_iters=16)
        r64 = run(torch.float64, steps, prox_method="ns", ns_iters=16)
        print(f"  {label} {steps} steps ns16 against ns16 in float64 {rel(r.zopt, r64.zopt):.3e}")

    print("converging runs (abstol 1e-7, reltol 1e-6, stallwindow 100): steps, gap, s")
    oracle = dict(abstol=1e-7, reltol=1e-6, stallwindow=100)
    for label, cap in (("max-cut", 1000), ("dense", 3000)):
        for rname, dt, kw in (("syevj", torch.float32, {}), ("f64", torch.float32, {}),
                              ("f64", torch.float64, {}),
                              ("ns24", torch.float32, {"prox_method": "ns"})):
            route = ROUTES.get(rname, eigh_syevj)
            cfg = ADMMConfig(maxiters=cap, **oracle)
            t = time.perf_counter()
            if label == "max-cut":
                r = with_route(route, lambda: sdp(Cmc.to(dt), "diag", ones.to(dt), cfg, **kw))
                gap = maxcut_gap(Cmc, r, cfg.rho)
                desc = f"certified gap {gap[0]:.3e} (primal {gap[1]:.6f}, dual {gap[2]:.6f})"
            else:
                r = with_route(route, lambda: sdp(Cd.to(dt), Ad.to(dt), bd.to(dt), cfg, **kw))
                obj = float(torch.sum(Cd.double() * r.zopt.double()))
                desc = f"gap to the optimum {abs(obj - pstar) / max(1.0, abs(pstar)):.3e}"
            print(f"  {label} {rname:6s} {dt}: steps {r.steps} (stalled={r.stalled}), {desc}, "
                  f"{time.perf_counter() - t:.2f} s")


if __name__ == "__main__":
    main()
