"""Linear-operator protocol for the ADMM constraint A x + B z = c (port of
``admm_tpu/linop.py``: ``ScaledIdentityOp``, ``DenseOp``, ``DiffOp``,
``StackIDiffOp``, ``FnOp`` and ``as_linop``).

Every operator provides:
  - ``mv(v)``   : A @ v
  - ``rmv(v)``  : A.T @ v
  - ``out_shape(in_shape)`` for size inference.

All but ``FnOp``, whose callables are the caller's, are marked
``graphs.capture_safe``: the engine may capture their applications in a
CUDA graph.
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch

from .graphs import capture_safe


@capture_safe
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


@capture_safe
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


@capture_safe
class DiffOp:
    """The total-variation difference operator.

    Matches the reference's D = spdiags([1, -1], 0:1, n, n)
    (solvers/totalvariation.m:127): upper-bidiagonal with D[i,i] = 1,
    D[i,i+1] = -1, and last row [0 ... 0 1], i.e.
    (Dx)_i = x_i - x_{i+1} for i < n, (Dx)_n = x_n.
    Applied matrix-free: O(n) instead of an O(n^2) matmul.
    """

    def __init__(self, n: int):
        self.n = n

    def mv(self, v):
        return v - torch.cat((v[1:], v.new_zeros(1)))

    def rmv(self, v):
        # D^T v: (D^T v)_i = v_i - v_{i-1}; (D^T v)_1 = v_1.
        return v - torch.cat((v.new_zeros(1), v[:-1]))

    def out_shape(self, in_shape):
        return in_shape

    def dense(self, dtype=torch.float64, device=None):
        eye = torch.eye(self.n, dtype=dtype, device=device)
        return eye - torch.diag(torch.ones(self.n - 1, dtype=dtype, device=device), 1)

    def __repr__(self):
        return f"DiffOp({self.n})"


@capture_safe
class StackIDiffOp:
    """The fused-lasso stacked operator A = [I; D] applied matrix-free:
    ``mv(x) = cat([x, Dx])`` (2n,), ``rmv(v) = v[:n] + D^T v[n:]``, O(n)
    element-wise work instead of a dense (2n, n) GEMV per residual/dual
    evaluation (models/fusedlasso.py)."""

    def __init__(self, n: int):
        self.n = n
        self._D = DiffOp(n)

    def mv(self, v):
        return torch.cat((v, self._D.mv(v)))

    def rmv(self, v):
        return v[: self.n] + self._D.rmv(v[self.n:])

    def out_shape(self, in_shape):
        return (2 * self.n,) + tuple(in_shape[1:])

    def __repr__(self):
        return f"StackIDiffOp({self.n})"


class FnOp:
    """A matrix-free operator from explicit mv/rmv callables (the
    reference's function-handle A with explicit nA, admm.m:121-130):
    ``mv(v) = mv_fn(v, *data)``.  Its output shape is unknown, so a solve
    with a scalar c must give ``m``."""

    def __init__(self, mv: Callable, rmv: Callable, data=()):
        self._mv = mv
        self._rmv = rmv
        self.data = tuple(data)

    def mv(self, v):
        return self._mv(v, *self.data)

    def rmv(self, v):
        return self._rmv(v, *self.data)

    def out_shape(self, in_shape):
        return None  # unknown; the caller supplies m

    def __repr__(self):
        return f"FnOp({getattr(self._mv, '__name__', 'mv')})"


def as_linop(A, *, device=None, dtype=None) -> object:
    """Coerce matrices / scalars / operators into a LinOp (admm.m:112-158).

    Anything exposing the mv/rmv/out_shape protocol passes through
    (``FnOp`` and user operator classes, the reference's function-handle
    A/B).  A
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
