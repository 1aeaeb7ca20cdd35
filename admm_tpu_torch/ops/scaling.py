"""Ruiz equilibration for the constrained-program families (LP / QP); the
port's own copy of ``admm_tpu/ops/scaling.py`` (NumPy f64 on the host, as
there: the port imports nothing of ``admm_tpu``).

ADMM's convergence rate degrades with the conditioning of the problem
data; the reference has no preconditioning (its testers generate
well-scaled instances).  This module implements the standard
modified-Ruiz scheme on the symmetric KKT structure

    [[P, Dᵀ],
     [D, 0 ]]

(the OSQP preconditioner; P = 0 for the LP): iteratively scale toward
unit row/column infinity norms, blockwise — the (n+m)² KKT matrix is
never formed.  The resulting positive diagonals (e, r) transform

    min ½ xᵀPx + qᵀx  s.t. Dx = s, x ≥ 0        (or lb ≤ x ≤ ub)

into the equivalent problem in x̃ = E⁻¹x (E = diag(e)):

    P̃ = EPE,  q̃ = Eq,  D̃ = RDE,  s̃ = Rs,  l̃b = E⁻¹lb,  ũb = E⁻¹ub

whose cones are preserved (positive diagonal scaling maps the
nonnegative orthant / box to themselves) and whose objective VALUE is
unchanged.  Solutions map back as x = E x̃; the scaled duals carried by
the engine transform the same way under the A=1, B=-1 splitting.

Setup-time cost: ``iters`` passes of blockwise abs/max/multiply on the
host (NumPy f64) — negligible next to the KKT factorization.
"""

from __future__ import annotations

import numpy as np


def _colmax(M):
    return np.max(np.abs(M), axis=0)


def _rowmax(M):
    return np.max(np.abs(M), axis=1)


def ruiz_equilibrate(D=None, P=None, iters: int = 15):
    """Blockwise symmetric Ruiz on [[P, Dᵀ], [D, 0]].

    Returns ``(e, r)``: positive column scales (n,) for the variable
    block and row scales (m,) for the constraint block, as NumPy f64.
    ``P=None`` means the zero block (LP); ``D=None`` means no
    constraint block (bounded QP — symmetric Ruiz on P alone, r = ()).
    Zero rows/columns keep scale 1 (nothing to equilibrate).
    """
    P = None if P is None else np.asarray(P, np.float64)
    if D is None:
        if P is None:
            raise ValueError("need at least one of D, P")
        n, m = P.shape[0], 0
        D = np.zeros((0, n))
    else:
        D = np.asarray(D, np.float64)
        m, n = D.shape
    e = np.ones(n)
    r = np.ones(m)
    for _ in range(int(iters)):
        Db = (r[:, None] * D) * e[None, :]
        # Dᵀ contribution to the variable rows (empty D -> zeros)
        top = _colmax(Db) if m else np.zeros(n)
        if P is not None:
            Pb = (e[:, None] * P) * e[None, :]
            top = np.maximum(top, _rowmax(Pb))
        e *= 1.0 / np.sqrt(np.where(top > 0, top, 1.0))
        if m:
            bot = _rowmax(Db)
            r *= 1.0 / np.sqrt(np.where(bot > 0, bot, 1.0))
    return e, r


def kkt_scale_quality(D, P=None, e=None, r=None):
    """Max/min nonzero row-∞-norm ratio of the (scaled) KKT structure —
    1.0 is perfectly equilibrated.  Diagnostic used by tests."""
    D = np.asarray(D, np.float64)
    if e is None:
        e = np.ones(D.shape[1])
    if r is None:
        r = np.ones(D.shape[0])
    Db = (r[:, None] * D) * e[None, :]
    top = _colmax(Db) if D.shape[0] else np.zeros(D.shape[1])
    if P is not None:
        Pb = (e[:, None] * np.asarray(P, np.float64)) * e[None, :]
        top = np.maximum(top, _rowmax(Pb))
    norms = np.concatenate([top, _rowmax(Db) if D.shape[0] else np.zeros(0)])
    norms = norms[norms > 0]
    return float(np.max(norms) / np.min(norms))
