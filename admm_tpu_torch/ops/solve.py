"""rho-parameterized linear-solve caches (port of ``admm_tpu/ops/solve.py``:
``SymShiftSolver``, ``WoodburySolver`` and ``FatShiftSolver``).

The reference caches Cholesky/LU factorizations keyed on "has rho changed"
(getProxOps.m:968-971; solvers/lasso.m:160-177).  As in ``admm_tpu``, rho
is folded analytically instead:

    (M + rho I)^{-1} b  =  V ((V^T b) / (w + rho)),   M = V diag(w) V^T

with the symmetric eigendecomposition computed once at setup, so each
application is two dense GEMVs plus an elementwise scale.  All three
solvers take float32 or float64 operands and keep them on their device;
``FatShiftSolver`` also streams bf16 (through the K2 kernel on the card).
The setup algebra runs under the caller's precision pin
(``models._common.timed_solver``).
"""

from __future__ import annotations

import torch

from .gemv_pair import aligned_rows, gemv_pair


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
    ``ops/gemv_pair.gemv_pair`` at K = 1: the CUDA C++ kernel K2 on the
    card, or its plain version on the CPU.  The kernel reads E and D^T as
    row-major rows, so bf16 keeps ``Dt``, a row-major copy of D^T, and E
    in row-major form (``torch.linalg.solve`` returns it column-major).
    f32 and f64 streams stay ``torch.matmul``.
    """

    def __init__(self, D, E, rho0):
        self.D = D
        self.E = E
        self.rho0 = rho0
        if D.dtype == torch.bfloat16:
            self.E = aligned_rows(E)
            self.Dt = aligned_rows(D.T)

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
            DtEb = gemv_pair(bs, self.E, self.Dt).to(b.dtype)
        else:
            DtEb = self.D.T @ (self.E @ b)
        return b / rho0 - DtEb / (rho0 * rho0)
