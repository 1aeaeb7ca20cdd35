"""Standard-form semidefinite programming via ADMM (port of
``admm_tpu/models/sdp.py``):

    min <C, X>   s.t.   A(X) = b,   X in the PSD cone

with A(X)_i = <A_i, X> for symmetric data matrices A_i (i = 1..m).

Beyond-reference family: the reference has no SDP solver, but this is
the canonical matrix-valued conic program of the ADMM literature (Boyd
et al. 2011 section 6; Wen, Goldfarb & Yin 2010) and slots straight
into the engine machinery the reference's covariance selection already
exercises (matrix iterates, admm.m:478-492; spectral z-prox shape,
getProxOps.m:1487-1496).

Splitting (X - Z = 0):

    f(X) = <C, X> + indicator{A(X) = b}
    g(Z) = indicator{Z >= 0 (PSD)}

x-prox:  affine projection.  With V = Z - U - C/rho,
             X = V - A^T (G^{-1} (A(V) - b)),   G = A A^T  (m x m Gram)
         G is factored once at setup (Cholesky) and the rho-dependence
         is the element-wise C/rho shift — no refactorization inside the
         loop, valid for any runtime rho; each step is two GEMVs over the
         (m, n*n) stack and a triangular pair, nothing read back.
z-prox:  PSD-cone projection of X + U — exact eigh (``ops/prox.psd_project``:
         cuSOLVER's ``syevd`` on the card, in f64 for an f32 matrix of
         order up to 512, where torch's own f32 eigh would take the Jacobi
         ``syevj``; one host read of its ``info`` a step) or the
         Newton-Schulz GEMM-only evaluation (``ops/matfun.psd_project_ns``,
         nothing read back).

Constraint forms:

- dense: ``A`` is an (m, n, n) stack of symmetric matrices (A(V) is one
  GEMV over the flattened stack).
- ``A='diag'``: the diagonal constraint diag(X) = b (m = n), the
  max-cut / Goemans-Williamson relaxation.  Then G = I and the affine
  projection is "overwrite the diagonal with b" — O(n) per iteration,
  and no (n, n, n) tensor is ever formed.

At a KKT point the scaled dual recovers the dual slack matrix:
S = C - A^T y = -rho * U (up to sign conventions), so -rho * uopt must be
PSD and complementary to X.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from ..config import ADMMConfig
from ..device import resolve_device
from ..engine import Hooks, admm
from ..ops.matfun import psd_project_ns
from ..ops.prox import psd_project
from ..ops.solve import cho_factor, cho_solve
from ..results import ADMMResults
from . import register
from ._common import as_tensor, bind_data, merge_config, timed_solver


def check_gram_conditioning(L, bar_frac: float = 0.01):
    """Reject (near-)linearly dependent constraint stacks at setup.

    ``cho_factor`` fails silently on a singular Gram (NaNs, or a
    rounding-noise pivot for exactly dependent rows) and the solve would
    degrade to a garbage or diverged run.  Estimate cond(G) from the
    Cholesky pivots ((dmax/dmin)^2 bounds it below) and fail clearly.
    Reads the factor on the host once, at setup."""
    piv = torch.abs(torch.diagonal(L))
    eps = float(torch.finfo(L.dtype).eps)
    cond_est = float(torch.max(piv) / torch.clamp_min(torch.min(piv), 0.0)) ** 2
    if not np.isfinite(cond_est) or cond_est > bar_frac / eps:
        raise ValueError(
            "constraint matrices A_i are (near-)linearly dependent: the "
            f"Gram G = A A^T has condition estimate {cond_est:.2e}; "
            "remove redundant constraints")


def _sym(M):
    return 0.5 * (M + M.transpose(-1, -2))


def _prox_f_dense(X, Z, U, rho, d):
    V = Z - U - d["C"] / rho
    A = d["A"].reshape(d["A"].shape[0], -1)
    y = cho_solve((d["L"], True), A @ V.reshape(-1) - d["b"])
    return V - (y @ A).reshape(V.shape)


def _prox_f_diag(X, Z, U, rho, d):
    # G = A A^T = I for the diagonal constraint: the affine projection
    # just overwrites diag(V) with b.
    V = Z - U - d["C"] / rho
    return V - torch.diag(torch.diagonal(V) - d["b"])


def _prox_g(X, Z, U, rho, d):
    return psd_project(U + X)


def _ns_prox_g(ns_iters: int, ns_coarse: int, ns_correct: int, ns_delta: float):
    """The Newton-Schulz z-prox with its knobs bound."""
    return functools.partial(_ns_prox, iters=ns_iters, coarse=ns_coarse, correct=ns_correct,
                             delta=ns_delta)


def _ns_prox(X, Z, U, rho, d, *, iters, coarse, correct, delta):
    return psd_project_ns(U + X, iters, coarse, correct, delta)


def _obj(X, Z, d):
    return torch.sum(d["C"] * X)


def make_prox_ops(C, A, b, config: ADMMConfig = ADMMConfig(), *,
                  prox_method: str = "eigh", ns_iters: int = 24,
                  ns_coarse: int = 0, ns_correct: int = 0,
                  ns_delta: float = 0.0, device=None):
    """Build (prox_f, prox_g, obj, data) for the standard-form SDP.

    ``A`` is an (m, n, n) stack (symmetrized here) or the string
    ``'diag'`` for diag(X) = b.  ``prox_method='ns'`` swaps the eigh
    PSD projection for the Newton-Schulz matmul-only evaluation
    (``ns_*`` knobs as in ``ops/matfun.psd_project_ns`` — see its
    conditioning caveat; 'eigh' is the accuracy reference).  The operands
    (numpy arrays or tensors) go to ``device``, or to the device of the
    first tensor among C, A, b, or to the CUDA device
    (``device.resolve_device``), in C's dtype."""
    if prox_method not in ("eigh", "ns"):
        raise ValueError(f"prox_method must be 'eigh' or 'ns', got {prox_method!r}")
    if prox_method == "ns" and int(ns_correct) > 0 and float(ns_delta) == 0.0:
        # The residual correction applies the coupled inverse root, which
        # blows up on the near-singular W^2 of a PSD projection: fail at
        # setup instead of NaNs at runtime.
        raise ValueError(
            "prox_method='ns' with ns_correct > 0 requires ns_delta > 0: "
            "the residual correction's inverse root diverges on the "
            "near-singular projection argument (ops/matfun.psd_project_ns)")
    device = resolve_device(device, C, A, b)
    C = as_tensor(C).to(device)
    n = C.shape[-1]
    if tuple(C.shape) != (n, n):
        raise ValueError(f"C must be square, got {tuple(C.shape)}")
    C = _sym(C)
    b = torch.atleast_1d(as_tensor(b).to(device=device, dtype=C.dtype))
    data = {"C": C, "b": b}
    if isinstance(A, str):
        if A != "diag":
            raise ValueError(f"string A must be 'diag', got {A!r}")
        if tuple(b.shape) != (n,):
            raise ValueError(f"diag constraint needs b of shape {(n,)}, got {tuple(b.shape)}")
        pf = _prox_f_diag
    else:
        A = _sym(as_tensor(A).to(device=device, dtype=C.dtype))
        if A.ndim != 3 or tuple(A.shape[1:]) != (n, n):
            raise ValueError(f"A must be (m, {n}, {n}) or 'diag', got {tuple(A.shape)}")
        m = A.shape[0]
        if tuple(b.shape) != (m,):
            raise ValueError(f"b must have shape {(m,)}, got {tuple(b.shape)}")
        Af = A.reshape(m, -1)
        L, _ = cho_factor(Af @ Af.T, lower=True)
        check_gram_conditioning(L)
        data.update({"A": A, "L": L})
        pf = _prox_f_dense
    pg = (_prox_g if prox_method == "eigh"
          else _ns_prox_g(int(ns_iters), int(ns_coarse), int(ns_correct), float(ns_delta)))
    return pf, pg, _obj, data


@register("sdp")
def _registry_entry(C, A, b, config=ADMMConfig(), prox_method="eigh",
                    ns_iters=24, ns_coarse=0, ns_correct=0, ns_delta=0.0,
                    device=None, **_):
    return bind_data(*make_prox_ops(C, A, b, config, prox_method=prox_method,
                                    ns_iters=ns_iters, ns_coarse=ns_coarse,
                                    ns_correct=ns_correct, ns_delta=ns_delta, device=device))


@timed_solver
def sdp(C=None, A=None, b=None, config: ADMMConfig = ADMMConfig(), *,
        prox_method: str = "eigh", ns_iters: int = 24, ns_coarse: int = 0,
        ns_correct: int = 0, ns_delta: float = 0.0,
        x0=None, z0=None, u0=None, device=None, **overrides) -> ADMMResults:
    """Solve min <C, X> s.t. A(X) = b, X PSD (standard-form SDP).

    Iterates are n-by-n matrices with zero initial state (the
    covariance-selection convention, covarianceselection.m:164-166).
    ``results.zopt`` is the PSD-feasible iterate, ``results.xopt`` the
    affine-feasible one; ``-rho * results.uopt`` estimates the dual
    slack matrix S = C - A^T y.

    ``A='diag'`` selects the diag(X) = b constraint (max-cut
    relaxation) with an O(n)-per-iteration affine projection.  Placement
    and dtype as in ``make_prox_ops``.
    """
    if C is None or A is None or b is None:
        raise ValueError("sdp requires C, A, b (no demo dataset is defined)")
    config = merge_config(config, overrides, body="heavy")
    prox_f, prox_g, obj, data = make_prox_ops(
        C, A, b, config, prox_method=prox_method, ns_iters=ns_iters,
        ns_coarse=ns_coarse, ns_correct=ns_correct, ns_delta=ns_delta, device=device)
    n = data["C"].shape[-1]
    return admm(
        prox_f, prox_g, config,
        A=1.0, B=-1.0, c=0.0, shape_x=(n, n), shape_z=(n, n),
        x0=x0, z0=z0, u0=u0,
        hooks=Hooks(obj=obj), dtype=data["C"].dtype, data=data, device=data["C"].device,
    )


def random_sdp_instance(n: int, m: int, r: int, rng=None, dtype=np.float64):
    """Seeded SDP instance with a known primal-dual optimal pair, for
    oracle tests (the port's own copy of ``admm_tpu``'s, NumPy on the
    host).

    Construction: draw an orthonormal Q; split its columns into a rank-r
    primal block and a rank-(n-r) dual block.  Set
        X* = Q_1 diag(p) Q_1^T  (p > 0),    S* = Q_2 diag(q) Q_2^T  (q > 0)
    so X* S* = 0 with X* + S* strictly complementary.  Draw symmetric
    A_i and y*, then  C = S* + sum_i y*_i A_i  and  b = A(X*)  make
    (X*, y*, S*) satisfy the full KKT system, hence optimal with zero
    duality gap.  Returns (C, A, b, Xstar, ystar, Sstar).
    """
    rng = np.random.default_rng(0) if rng is None else rng
    M = rng.standard_normal((n, n))
    Q, _ = np.linalg.qr(M)
    p = rng.uniform(0.5, 2.0, size=r)
    q = rng.uniform(0.5, 2.0, size=n - r)
    Xstar = (Q[:, :r] * p) @ Q[:, :r].T
    Sstar = (Q[:, r:] * q) @ Q[:, r:].T
    A = rng.standard_normal((m, n, n))
    A = 0.5 * (A + np.swapaxes(A, -1, -2))
    ystar = rng.standard_normal(m)
    C = Sstar + np.einsum("m,mij->ij", ystar, A)
    b = np.einsum("mij,ij->m", A, Xstar)
    return (C.astype(dtype), A.astype(dtype), b.astype(dtype),
            Xstar.astype(dtype), ystar.astype(dtype), Sstar.astype(dtype))
