"""Sparse inverse covariance selection (graphical lasso; port of
``admm_tpu/models/covarianceselection.py``):

    min tr(S X) - logdet(X) + lambda ||Z||_1   s.t.   X - Z = 0

over symmetric positive-definite matrices X — matrix-valued iterates
(reference admm.m:478-492).

Reference: solvers/covarianceselection.m (wrapper; S = cov(D) at :145,
matrix-valued zero initial state :164-166) and getProxOps.m case
'covarianceselection' (:669-750) with x-prox xminCovarianceSelection
(getProxOps.m:1487-1496).

x-update:  eigendecompose rho (Z - U) - S = Q diag(e) Q^T,
           X = Q diag((e + sqrt(e^2 + 4 rho)) / (2 rho)) Q^T
z-update:  soft_threshold(U + X, lambda / rho)   (matrix-elementwise)

Two x-prox evaluations, selected by ``prox_method``:

- ``'eigh'`` (default, exact): ``torch.linalg.eigh`` every step
  (``ops/prox.sym_eigh``) — cuSOLVER's ``syevd`` on the card, in f64 for
  an f32 matrix of order up to 512, where torch's own f32 eigh would take
  the Jacobi ``syevj``; its ``info`` check reads back to the host once a
  step (the step's one synchronising call).
- ``'ns'``: the same spectral function evaluated as
  (W + sqrt(W^2 + 4 rho I)) / (2 rho) with a Newton-Schulz matrix square
  root (``ops/matfun.py``) — cuBLAS GEMMs only, nothing read back.
  ``ns_iters`` (default 20) covers kappa(W^2+4rho I) up to ~1e7 at f64
  machine precision.
- ``'ns_fast'``: 'ns' with every square-root step at reduced float32
  matmul precision (tensor cores) and 2 full-precision residual
  corrections.
"""

from __future__ import annotations

import functools

import torch

from ..config import ADMMConfig
from ..device import resolve_device
from ..engine import Hooks, admm
from ..ops.matfun import covsel_ns_prox
from ..ops.prox import covsel_eig_prox, soft_threshold
from ..results import ADMMResults
from . import register
from ._common import as_tensor, bind_data, merge_config, timed_solver


def _prox_f(X, Z, U, rho, d):
    return covsel_eig_prox(rho * (Z - U) - d["S"], rho)


def _ns_prox_f(ns_iters: int, ns_coarse: int = 0, ns_correct: int = 0):
    """The Newton-Schulz x-prox with its step counts bound."""
    return functools.partial(_ns_prox, iters=ns_iters, coarse=ns_coarse, correct=ns_correct)


def _ns_prox(X, Z, U, rho, d, *, iters, coarse, correct):
    return covsel_ns_prox(rho * (Z - U) - d["S"], rho, iters, coarse, correct)


def _prox_g(X, Z, U, rho, d):
    return soft_threshold(U + X, d["lam"] / rho)


def _obj(X, Z, d):
    sign, logdet = torch.linalg.slogdet(X)
    return torch.trace(d["S"] @ X) - logdet + d["lam"] * torch.sum(torch.abs(Z))


def make_prox_ops(S, lam, config: ADMMConfig = ADMMConfig(), *,
                  prox_method: str = "eigh", ns_iters: int = 20,
                  ns_coarse: int = 0, ns_correct: int = 0):
    """Build (prox_f, prox_g, obj, data) from the empirical covariance S, a
    tensor on the solve's device (getProxOps.m:669-750).

    ``prox_method='ns'`` swaps the eigh x-prox for the Newton-Schulz
    matmul-only evaluation (``ns_iters`` square-root steps).
    ``ns_coarse`` runs that many leading NS steps at reduced float32
    matmul precision and ``ns_correct`` appends that many full-precision
    residual corrections (``ops/matfun.ns_sqrtm``); ``'ns_fast'`` is
    ns_coarse = ns_iters with ns_correct >= 2.
    """
    if prox_method not in ("eigh", "ns", "ns_fast"):
        raise ValueError(
            f"prox_method must be 'eigh', 'ns' or 'ns_fast', got {prox_method!r}")
    if prox_method == "ns_fast":
        ns_coarse, ns_correct = ns_iters, max(int(ns_correct), 2)
    data = {"S": S, "lam": torch.as_tensor(lam, dtype=S.dtype, device=S.device)}
    pf = (_prox_f if prox_method == "eigh"
          else _ns_prox_f(int(ns_iters), int(ns_coarse), int(ns_correct)))
    return pf, _prox_g, _obj, data


@register("covarianceselection")
def _registry_entry(S, lam, config=ADMMConfig(), prox_method="eigh", ns_iters=20,
                    ns_coarse=0, ns_correct=0, device=None, **_):
    S = as_tensor(S).to(resolve_device(device, S))
    return bind_data(*make_prox_ops(S, lam, config, prox_method=prox_method,
                                    ns_iters=ns_iters, ns_coarse=ns_coarse,
                                    ns_correct=ns_correct))


def empirical_covariance(D):
    """cov(D) with rows = samples, matching MATLAB's cov
    (covarianceselection.m:145): unbiased, mean-removed.  ``D`` is a
    tensor; the result keeps its dtype and device."""
    Dc = D - torch.mean(D, dim=0, keepdim=True)
    return (Dc.T @ Dc) / (D.shape[0] - 1)


@timed_solver
def covarianceselection(D=None, lam=None, config: ADMMConfig = ADMMConfig(), *,
                        prox_method: str = "eigh", ns_iters: int = 20,
                        ns_coarse: int = 0, ns_correct: int = 0,
                        x0=None, z0=None, u0=None, device=None,
                        **overrides) -> ADMMResults:
    """Solve covariance selection (reference solvers/covarianceselection.m:80).

    ``D`` holds samples in rows; the empirical covariance is formed here
    (covarianceselection.m:145).  Iterates are n-by-n matrices with zero
    initial state (covarianceselection.m:164-166).  ``D`` is a numpy array
    or a tensor; the solve runs in D's dtype on ``device``, or on D's
    device when D is a tensor, or on the CUDA device
    (``device.resolve_device``).

    ``prox_method='ns'`` selects the matmul-only Newton-Schulz x-prox (no
    eigh and no host read inside the loop); ``'ns_fast'`` also runs the
    square-root steps at reduced float32 matmul precision with 2
    full-precision residual corrections (``make_prox_ops``).  Called
    with no arguments it runs its tester's demo instance
    (``testers.problems``) on ``device``.
    """
    if D is None:
        # Zero-arg demo mode (reference solvers, e.g. lasso.m:122-129).
        from ..testers.problems import covarianceselectiontest

        res, _test = covarianceselectiontest(quiet=False, device=device)
        return res
    config = merge_config(config, overrides, body="heavy")
    device = resolve_device(device, D)
    S = empirical_covariance(as_tensor(D).to(device))
    n = S.shape[0]
    prox_f, prox_g, obj, data = make_prox_ops(S, lam, config, prox_method=prox_method,
                                              ns_iters=ns_iters, ns_coarse=ns_coarse,
                                              ns_correct=ns_correct)
    return admm(
        prox_f, prox_g, config,
        A=1.0, B=-1.0, c=0.0, shape_x=(n, n), shape_z=(n, n),
        x0=x0, z0=z0, u0=u0,
        hooks=Hooks(obj=obj), dtype=S.dtype, data=data, device=device,
    )
