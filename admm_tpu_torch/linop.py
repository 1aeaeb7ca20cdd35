"""Linear-operator protocol for the ADMM constraint A x + B z = c (port of
``admm_tpu/linop.py``: ``ScaledIdentityOp``, ``DenseOp`` and ``as_linop``).

Every operator provides:
  - ``mv(v)``   : A @ v
  - ``rmv(v)``  : A.T @ v
  - ``out_shape(in_shape)`` for size inference.
"""

from __future__ import annotations

import numpy as np
import torch


class ScaledIdentityOp:
    """alpha * I.  The reference's scalar-A/B fast path (admm.m:145-153)."""

    def __init__(self, alpha=1.0):
        self.alpha = alpha

    def mv(self, v):
        if isinstance(self.alpha, (int, float)) and self.alpha == 1.0:
            return v
        if isinstance(self.alpha, (int, float)) and self.alpha == -1.0:
            return -v
        return self.alpha * v

    rmv = mv

    def out_shape(self, in_shape):
        return in_shape

    def __repr__(self):
        return f"ScaledIdentityOp({self.alpha})"


class DenseOp:
    """A dense matrix operator."""

    def __init__(self, M):
        self.M = M

    def mv(self, v):
        return self.M @ v

    def rmv(self, v):
        return self.M.T @ v

    def out_shape(self, in_shape):
        return (self.M.shape[0],) + tuple(in_shape[1:])

    def __repr__(self):
        return f"DenseOp{tuple(self.M.shape)}"


def as_linop(A, *, device=None, dtype=None) -> object:
    """Coerce matrices / scalars / operators into a LinOp (admm.m:112-158).

    Anything exposing the mv/rmv/out_shape protocol passes through.  A
    numpy or torch matrix becomes a ``DenseOp`` on ``device`` (default:
    the tensor's own device, or the CPU for numpy input)."""
    if hasattr(A, "mv") and hasattr(A, "rmv"):
        if not hasattr(A, "out_shape"):
            raise TypeError(
                f"operator {type(A).__name__} defines mv/rmv but not "
                "out_shape(in_shape); implement it (return None if unknown)"
            )
        return A
    if isinstance(A, (int, float)):
        return ScaledIdentityOp(float(A))
    if not isinstance(A, torch.Tensor):
        A = torch.as_tensor(np.asarray(A))
    A = A.to(device=device, dtype=dtype)
    if A.ndim == 0:
        return ScaledIdentityOp(A)
    if A.ndim == 2:
        return DenseOp(A)
    raise TypeError(f"Cannot interpret {type(A)} with ndim {A.ndim} as a linear operator")
