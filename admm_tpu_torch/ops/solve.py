"""rho-parameterized linear-solve caches (port of ``admm_tpu/ops/solve.py``:
``SymShiftSolver``, ``WoodburySolver``, ``FatShiftSolver`` and the KKT
solvers ``kkt_eq_solver``, ``AffineKKTSolver`` and ``StaticKKTSolver``).

The reference caches Cholesky/LU factorizations keyed on "has rho changed"
(getProxOps.m:968-971; solvers/lasso.m:160-177).  As in ``admm_tpu``, rho
is folded analytically instead:

    (M + rho I)^{-1} b  =  V ((V^T b) / (w + rho)),   M = V diag(w) V^T

with the symmetric eigendecomposition computed once at setup, so each
application is two dense GEMVs plus an elementwise scale.  All solvers
take float32 or float64 operands and keep them on their device;
``FatShiftSolver`` also streams bf16 (through the K2 kernel on the card).
The setup algebra runs under the caller's precision pin
(``models._common.timed_solver``).

The KKT solvers factor through ``cho_factor``: ``torch.linalg.cholesky_ex``
with a failed factor turned into NaNs on the device, as JAX's
``cho_factor`` fails (silently, in NaNs, which the engine's nanguard
catches), and without the host read of ``torch.linalg.cholesky``'s error
check.  ``cho_solve`` is the two triangular solves, so neither reads
anything back and the dynamic-rho solve, which factors every step, keeps a
sub-step free of synchronising calls.
"""

from __future__ import annotations

import torch

from .gemv_pair import StreamPair, aligned_rows


class SymShiftSolver:
    """Solves (M + rho*I) x = b for symmetric PSD M via cached eigh."""

    def __init__(self, V, w):
        self.V = V
        self.w = w

    @classmethod
    def from_matrix(cls, M) -> "SymShiftSolver":
        M = 0.5 * (M + M.T)  # enforce symmetry for eigh stability
        w, V = torch.linalg.eigh(M)
        return cls(V, w)

    def solve(self, b, rho):
        y = self.V.T @ b
        y = y / (self.w + rho)
        return self.V @ y

    def materialize_inverse(self, rho):
        """Dense (M + rho I)^{-1} for the static-rho fast path: one GEMV per
        iteration instead of two (used when config.adaptive is False)."""
        return (self.V / (self.w + rho)[None, :]) @ self.V.T


class WoodburySolver:
    """Fat-matrix solve of (D^T D + rho I) x = b via the matrix-inversion
    lemma, matching the reference's fat-lasso branch
    (solvers/lasso.m:169-172; xminLASSO getProxOps.m:1198-1205):

        x = b/rho - (1/rho^2) D^T (D D^T/rho + I)^{-1} D b

    with the m-by-m Gram D D^T eigendecomposed once.
    """

    def __init__(self, D, V, w):
        self.D = D
        self.V = V  # eigvectors of D D^T
        self.w = w  # eigvalues of D D^T

    @classmethod
    def from_matrix(cls, D) -> "WoodburySolver":
        G = D @ D.T
        G = 0.5 * (G + G.T)
        w, V = torch.linalg.eigh(G)
        return cls(D, V, w)

    def solve(self, b, rho):
        Db = self.D @ b
        # (D D^T / rho + I)^{-1} Db  ==  V ((V^T Db) / (w/rho + 1))
        y = self.V.T @ Db
        y = y / (self.w / rho + 1.0)
        y = self.V @ y
        return b / rho - (self.D.T @ y) / (rho * rho)


class FatShiftSolver:
    """Static-rho fat-matrix solve of (D^T D + rho0 I) x = b.

    Folds the Woodbury middle factor into a single precomputed m-by-n
    stream matrix E = (D D^T / rho0 + I)^{-1} D, so each application is

        x = b / rho0 - D^T (E b) / rho0^2

    i.e. exactly two m-by-n GEMV streams per iteration.  Valid only for
    the fixed rho0 captured at construction (a 0-d tensor of D's dtype).

    ``stream_dtype=torch.bfloat16`` stores D and E in bf16 (half the
    bytes), as ``admm_tpu``'s bf16-stream mode does: b is rounded to bf16,
    both products accumulate in f32, E b is rounded to bf16 before the
    second product, and D^T (E b) stays f32.  ``torch.matmul`` on bf16
    operands would round that output to bf16, so the pair runs through
    ``ops/gemv_pair.StreamPair`` at K = 1: the CUDA C++ kernel K2 on the
    card, or its plain version on the CPU; lanes (b under
    ``torch.func.vmap``) take the plain version.  The kernel reads E and
    D^T as row-major rows, so bf16 keeps ``Dt``, a row-major copy of D^T,
    and E in row-major form (``torch.linalg.solve`` returns it
    column-major).  Under autograd and ``torch.func`` the pair is
    differentiable in b (D and E are constants): its backward is one K2
    launch of the transposed pair, on D and a row-major copy of E^T built
    at the first backward and kept.  f32 and f64 streams stay
    ``torch.matmul``.
    """

    def __init__(self, D, E, rho0):
        self.D = D
        self.E = E
        self.rho0 = rho0
        if D.dtype == torch.bfloat16:
            self.E = aligned_rows(E)
            self.Dt = aligned_rows(D.T)
            self.pair = StreamPair(self.E, self.Dt, Dt_T=D)

    @classmethod
    def from_matrix(cls, D, rho0, stream_dtype=None) -> "FatShiftSolver":
        if stream_dtype not in (None, D.dtype, torch.bfloat16):
            raise ValueError(
                f"FatShiftSolver: stream_dtype must be None, D's dtype or "
                f"torch.bfloat16, got {stream_dtype}")
        rho0_arr = torch.as_tensor(rho0, dtype=D.dtype, device=D.device)
        G = D @ D.T / rho0 + torch.eye(D.shape[0], dtype=D.dtype, device=D.device)
        E = torch.linalg.solve(0.5 * (G + G.T), D)
        if stream_dtype is not None:
            D = D.to(stream_dtype)
            E = E.to(stream_dtype)
        return cls(D, E, rho0_arr)

    def solve(self, b, rho=None):
        rho0 = self.rho0
        if self.D.dtype == torch.bfloat16:
            # K2 rounds an f32 b to bf16 itself; other dtypes round once here.
            bs = b if b.dtype == torch.float32 else b.to(torch.bfloat16)
            DtEb = self.pair(bs).to(b.dtype)
        else:
            DtEb = self.D.T @ (self.E @ b)
        return b / rho0 - DtEb / (rho0 * rho0)


def cho_factor(S, lower=True):
    """``(factor, lower)`` of the symmetric positive-definite S, as
    ``jax.scipy.linalg.cho_factor`` returns them: the factor is NaN where
    the factorization failed (its ``info`` is never read on the host)."""
    L, info = torch.linalg.cholesky_ex(S, upper=not lower)
    return torch.where((info == 0)[..., None, None], L, float("nan")), lower


def cho_solve(cf, b):
    """S^{-1} b for ``cf = cho_factor(S)`` and a vector (or a stack of
    columns) b: the two triangular solves of ``jax.scipy.linalg.cho_solve``."""
    F, lower = cf
    vec = b.ndim == 1
    B = b[:, None] if vec else b
    if lower:
        y = torch.linalg.solve_triangular(F, B, upper=False)
        y = torch.linalg.solve_triangular(F.transpose(-1, -2), y, upper=True)
    else:
        y = torch.linalg.solve_triangular(F.transpose(-1, -2), B, upper=False)
        y = torch.linalg.solve_triangular(F, y, upper=True)
    return y[:, 0] if vec else y


def _sym(M):
    return 0.5 * (M + M.T)


class kkt_eq_solver:
    """Equality-constrained quadratic KKT solve via Schur complement.

    Solves   [ P + rho*I  D^T ] [x]   [ b1 ]
             [     D       0  ] [y] = [ b2 ]
    returning x — the LP/QP-standard x-prox system
    (reference xminLinearProgram getProxOps.m:1357-1365 with P = 0,
    xminQuadraticProgramStandard getProxOps.m:1397-1412).

    Instead of assembling and LU-factoring the (n+m)^2 KKT matrix per rho
    change like the reference, eliminate x:

        x = Minv (b1 - D^T y),  Minv = (P + rho I)^{-1}  (eigh of P, cached)
        S(rho) y = D Minv b1 - b2,  S(rho) = D Minv D^T

    With G = D V cached, S(rho) = G diag(1/(w+rho)) G^T is formed by one
    m-by-n matmul pair and factored with an m-by-m Cholesky per call
    (``cho_factor``: no host read), valid for any runtime rho.
    """

    def __init__(self, D, V, w, G):
        self.D = D
        self.V = V  # eigvectors of P, or None when P = 0 (LP identity basis)
        self.w = w  # eigvalues of P (zeros for LP)
        self.G = G  # D @ V (== D when V is None)

    @classmethod
    def from_matrices(cls, D, P=None) -> "kkt_eq_solver":
        n = D.shape[1]
        if P is None:
            # LP: P = 0 -> identity eigenbasis, represented as V = None so
            # solve() skips the two identity matmuls and setup the n^3 eigh.
            return cls(D, None, D.new_zeros(n), D)
        w, V = torch.linalg.eigh(_sym(P))
        return cls(D, V, w, D @ V)

    def _schur(self, rho):
        inv_diag = 1.0 / (self.w + rho)
        return inv_diag, cho_factor(_sym((self.G * inv_diag[None, :]) @ self.G.T))

    def solve(self, b1, b2, rho):
        inv_diag, cf = self._schur(rho)
        # Minv b1 in the eigenbasis (identity basis for LP).
        t1 = inv_diag * (b1 if self.V is None else self.V.T @ b1)
        y = cho_solve(cf, self.G @ t1 - b2)
        t2 = t1 - inv_diag * (self.G.T @ y)
        return t2 if self.V is None else self.V @ t2

    def _minv(self, inv_diag):
        if self.V is None:
            return torch.diag(inv_diag)
        return (self.V * inv_diag[None, :]) @ self.V.T

    def materialize(self, rho) -> "StaticKKTSolver":
        """Fold the fixed-rho factorization once at setup: per-iteration
        work becomes two n-sized GEMVs + one triangular pair, no
        refactorization inside the loop."""
        inv_diag, cf = self._schur(rho)
        Minv = self._minv(inv_diag)
        # x = Minv b1 - MinvDt y;  y = cho_solve(S, D Minv b1 - b2)
        return StaticKKTSolver(Minv, Minv @ self.D.T, self.D, *cf)

    def materialize_affine(self, rho, b2) -> "AffineKKTSolver":
        """Fold the entire fixed-rho KKT solve into one affine map.

        The constraint right-hand side b2 is a per-problem constant, so

            x = Minv b1 - MinvDt S^{-1} (D Minv b1 - b2)
              = K1 b1 + x0,
            K1 = Minv - MinvDt S^{-1} D Minv,   x0 = MinvDt S^{-1} b2

        — the upper-left block of the KKT inverse applied by one n-by-n
        GEMV per iteration, with no triangular solve inside the loop.  For
        the LP (V=None), K1 is (1/rho) times the orthogonal projector onto
        null(D).  Forward error of the explicit-inverse apply is
        O(kappa(KKT) eps), the order of the factored solve's.
        """
        K1, W = self.materialize_affine_map(rho)
        return AffineKKTSolver(K1, W @ b2)

    def materialize_affine_map(self, rho):
        """Shared pieces of the fixed-rho affine fold, for callers with
        many constraint right-hand sides:

            x = K1 b1 + W b2,   W = MinvDt S^{-1}   (n-by-m)

        K1 and W depend only on (D, P, rho)."""
        inv_diag, cf = self._schur(rho)
        Minv = self._minv(inv_diag)
        MinvDt = Minv @ self.D.T
        K1 = _sym(Minv - MinvDt @ cho_solve(cf, self.D @ Minv))  # exact symmetry
        W = cho_solve(cf, MinvDt.T).T
        return K1, W


class AffineKKTSolver:
    """Fully-folded fixed-rho KKT apply (see
    ``kkt_eq_solver.materialize_affine``): x = K1 @ b1 + x0.

    ``solve`` keeps the (b1, b2, rho) signature of the other KKT solvers
    for drop-in use by the LP/QP x-prox; b2 and rho are ignored — both
    were folded into (K1, x0) at setup.
    """

    def __init__(self, K1, x0):
        self.K1 = K1
        self.x0 = x0

    def solve(self, b1, b2=None, rho=None):
        return self.K1 @ b1 + self.x0


class StaticKKTSolver:
    """Fixed-rho KKT apply: all factors precomputed (see
    ``kkt_eq_solver.materialize``).  ``cf`` is the Cholesky factor of the
    Schur complement, lower triangular when ``lower`` (the port's own) or
    upper (JAX's ``cho_factor`` default, carried across by ``convert``)."""

    def __init__(self, Minv, MinvDt, D, cf, lower):
        self.Minv = Minv
        self.MinvDt = MinvDt
        self.D = D
        self.cf = cf
        self.lower = bool(lower)

    def solve(self, b1, b2, rho=None):
        t1 = self.Minv @ b1
        y = cho_solve((self.cf, self.lower), self.D @ t1 - b2)
        return t1 - self.MinvDt @ y
