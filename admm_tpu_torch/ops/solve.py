"""rho-parameterized linear-solve caches (port of ``admm_tpu/ops/solve.py``:
``SymShiftSolver``, ``WoodburySolver`` and ``FatShiftSolver``).

The reference caches Cholesky/LU factorizations keyed on "has rho changed"
(getProxOps.m:968-971; solvers/lasso.m:160-177).  As in ``admm_tpu``, rho
is folded analytically instead:

    (M + rho I)^{-1} b  =  V ((V^T b) / (w + rho)),   M = V diag(w) V^T

with the symmetric eigendecomposition computed once at setup, so each
application is two dense GEMVs plus an elementwise scale.  All three
solvers take float32 or float64 operands and keep them on their device.
The setup algebra runs under the caller's precision pin
(``models._common.timed_solver``).
"""

from __future__ import annotations

import torch


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

    ``stream_dtype=torch.bfloat16`` is not ported: ``admm_tpu`` keeps the
    second GEMV's output in f32 (``preferred_element_type``) where
    ``torch.matmul`` on bf16 operands rounds it to bf16.  That needs a
    bf16-in/f32-out GEMV kernel (ROADMAP item K-ext-1).
    """

    def __init__(self, D, E, rho0):
        self.D = D
        self.E = E
        self.rho0 = rho0

    @classmethod
    def from_matrix(cls, D, rho0, stream_dtype=None) -> "FatShiftSolver":
        if stream_dtype is not None and stream_dtype != D.dtype:
            raise NotImplementedError(
                f"FatShiftSolver stream_dtype={stream_dtype} needs the "
                "bf16-in/f32-out GEMV kernel of ROADMAP item K-ext-1, which "
                "is not ported yet")
        rho0_arr = torch.as_tensor(rho0, dtype=D.dtype, device=D.device)
        G = D @ D.T / rho0 + torch.eye(D.shape[0], dtype=D.dtype, device=D.device)
        E = torch.linalg.solve(0.5 * (G + G.T), D)
        return cls(D, E, rho0_arr)

    def solve(self, b, rho=None):
        Eb = self.E @ b
        DtEb = self.D.T @ Eb
        rho0 = self.rho0
        return b / rho0 - DtEb / (rho0 * rho0)
