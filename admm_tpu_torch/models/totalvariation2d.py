"""2-D (image) total variation denoising (port of
``admm_tpu/models/totalvariation2d.py``, itself an extension with no
analog in the MATLAB reference, whose TV is 1-D):

    min 1/2 ||X - S||_F^2 + lambda ||Z||_1   s.t.   A X - Z = 0,
    A X = stack(D_r X, X D_c^T)

where D_r / D_c are PURE difference stencils ((Dv)_i = v_i - v_{i+1},
zero in the last slot), so a constant image has TV exactly 0.

x-update:  (I + rho (D_r^T D_r (+) D_c^T D_c)) X = S + rho A^T (Z - U),
           diagonalized by the two small 1-D eigenbases:
           X = U_r [ (U_r^T B U_c) / (1 + rho (wr_i + wc_j)) ] U_c^T,
           four dense matmuls per iteration, valid for any runtime rho.
z-update:  soft_threshold(A X + U, lambda / rho).

The matmuls go to ``torch.matmul`` (``admm_tpu`` leaves them to XLA); the
slice has no kernel of its own.
"""

from __future__ import annotations

import torch

from ..config import ADMMConfig
from ..device import resolve_device
from ..engine import Hooks, admm
from ..ops.prox import soft_threshold
from ..results import ADMMResults
from . import register
from ._common import as_tensor, bind_data, merge_config, timed_solver


def _d(v, axis):
    """Pure difference along ``axis``: (Dv)_i = v_i - v_{i+1}, last = 0."""
    size = v.shape[axis]
    lead = v.narrow(axis, 0, size - 1)
    trail = v.narrow(axis, 1, size - 1)
    zero = torch.zeros_like(v.narrow(axis, 0, 1))
    return torch.cat([lead - trail, zero], dim=axis)


def _dt(v, axis):
    """Adjoint of ``_d`` (the last slot of v is ignored by construction)."""
    body = v.narrow(axis, 0, v.shape[axis] - 1)
    zero = torch.zeros_like(v.narrow(axis, 0, 1))
    up = torch.cat([body, zero], dim=axis)      # v with last slot 0
    down = torch.cat([zero, body], dim=axis)    # shifted down by 1
    return up - down


def _dense_1d(n, dtype, device=None):
    """Dense pure-difference matrix D, built by applying the SAME stencil
    to the identity: _d(I, 0) applies it to each column, i.e. D @ I = D."""
    return _d(torch.eye(n, dtype=dtype, device=device), 0)


class TV2DOp:
    """A X = stack(D_r X, X D_c^T) with the pure-difference stencil."""

    def __init__(self, m: int, n: int):
        self.m = m
        self.n = n

    def mv(self, X):
        return torch.stack([_d(X, 0), _d(X, 1)])

    def rmv(self, V):
        return _dt(V[0], 0) + _dt(V[1], 1)

    def out_shape(self, in_shape):
        return (2,) + tuple(in_shape)

    def __repr__(self):
        return f"TV2DOp({self.m}, {self.n})"


def _prox_f(X, Z, U, rho, d):
    B = d["S"] + rho * d["A"].rmv(Z - U)
    Y = d["Ur"].T @ B @ d["Uc"]
    Y = Y / (1.0 + rho * (d["wr"][:, None] + d["wc"][None, :]))
    return d["Ur"] @ Y @ d["Uc"].T


def _prox_g(X, Z, U, rho, d):
    return soft_threshold(U + d["A"].mv(X), d["lam"] / rho)


def _prox_g_relaxed(AXhat, Z, U, rho, d):
    # Under relaxation the engine hands Axhat, already in A-space.
    return soft_threshold(U + AXhat, d["lam"] / rho)


def _obj(X, Z, d):
    return 0.5 * torch.sum((X - d["S"]) ** 2) + d["lam"] * torch.sum(torch.abs(Z))


def make_prox_ops(S, lam, config: ADMMConfig = ADMMConfig()):
    """Build (prox_f, prox_g, obj, data, A) for a 2-D tensor ``S``; the
    operands land on its device in its dtype.  The eigenbasis x-prox is
    valid for any runtime rho, so config selects only the
    relaxation-aware z-prox."""
    m, n = S.shape
    A = TV2DOp(m, n)
    Lr = _dense_1d(m, S.dtype, S.device)
    Lc = _dense_1d(n, S.dtype, S.device)
    wr, Ur = torch.linalg.eigh(Lr.T @ Lr)
    wc, Uc = torch.linalg.eigh(Lc.T @ Lc)
    data = {"S": S, "lam": torch.as_tensor(lam, dtype=S.dtype, device=S.device),
            "A": A, "Ur": Ur, "wr": wr, "Uc": Uc, "wc": wc}
    prox_g = _prox_g if config.relax == 1.0 else _prox_g_relaxed
    return _prox_f, prox_g, _obj, data, A


@register("totalvariation2d")
def _registry_entry(S, lam, config=ADMMConfig(), device=None, **_):
    S = as_tensor(S).to(resolve_device(device, S))
    pf, pg, obj, data, _A = make_prox_ops(S, lam, config)
    return bind_data(pf, pg, obj, data)


@timed_solver
def totalvariation2d(S, lam, config: ADMMConfig = ADMMConfig(), *,
                     x0=None, z0=None, u0=None, device=None,
                     **overrides) -> ADMMResults:
    """Denoise an image by anisotropic 2-D TV.

    ``S`` is a numpy array or a tensor; the solve runs in its dtype on
    ``device``, or on S's device when S is a tensor, or on the CUDA device
    (``device.resolve_device``)."""
    config = merge_config(config, overrides, body="gemv")
    device = resolve_device(device, S)
    S = as_tensor(S).to(device)
    m, n = S.shape
    prox_f, prox_g, obj, data, A = make_prox_ops(S, lam, config)
    return admm(
        prox_f, prox_g, config,
        A=A, B=-1.0, c=0.0,
        shape_x=(m, n), shape_z=(2, m, n),
        x0=x0, z0=z0, u0=u0,
        hooks=Hooks(obj=obj), dtype=S.dtype, data=data, device=device,
    )
