"""LASSO: min 1/2 ||D x - s||^2 + lambda ||z||_1  s.t.  x - z = 0
(port of ``admm_tpu/models/lasso.py``).

Reference: solvers/lasso.m (wrapper; serial precompute at lasso.m:160-177)
and getProxOps.m case 'lasso' (:313-456) with proxes xminLASSO
(getProxOps.m:1192-1206) and soft-thresholding z-update (getProxOps.m:455,
933-938).

x-update:  (D^T D + rho I)^{-1} (D^T s + rho (z - u)); the fat (m < n)
           branch goes through the matrix-inversion lemma.
z-update:  soft_threshold(x + u, lambda / rho), or with
           ``use_fused_kernel`` the fused z + dual-update pass of
           ``ops/kernels.py`` (a Triton kernel on the GPU).

Prox operators are module-level functions over a ``data`` dict of
tensors on the solve's device.
"""

from __future__ import annotations

import numpy as np
import torch

from ..config import ADMMConfig
from ..engine import Hooks, admm
from ..ops.kernels import fused_soft_threshold_dual
from ..ops.prox import soft_threshold
from ..ops.solve import FatShiftSolver, SymShiftSolver, WoodburySolver
from ..results import ADMMResults
from ._common import check_data_vector, merge_config, timed_solver


def _prox_f_static(x, z, u, rho, d):
    return d["Minv"] @ (d["Dts"] + rho * (z - u))


def _prox_f_adaptive(x, z, u, rho, d):
    return d["sol"].solve(d["Dts"] + rho * (z - u), rho)


def _prox_f_fat(x, z, u, rho, d):
    return d["wood"].solve(d["Dts"] + rho * (z - u), rho)


def _prox_f_fat_static(x, z, u, rho, d):
    return d["fat"].solve(d["Dts"] + rho * (z - u))


def _prox_g(x, z, u, rho, d):
    # zminSoftThresholding(u + x, lambda/rho) (getProxOps.m:455, 933-938)
    return soft_threshold(u + x, d["lam"] / rho)


def _obj(x, z, d):
    # solvers/lasso.m objective: 1/2||Dx - s||^2 + lambda*||z||_1
    return 0.5 * torch.sum((d["D"] @ x - d["s"]) ** 2) + d["lam"] * torch.sum(torch.abs(z))


def _fused_zu(x, u, rho, d):
    # One-pass z-prox + dual update (Hooks.fused_zu; ops/kernels.py).
    return fused_soft_threshold_dual(x, u, d["lam"] / rho)


def _to_device(v, device, dtype=None):
    t = v if isinstance(v, torch.Tensor) else torch.as_tensor(np.asarray(v))
    return t.to(device=device, dtype=dtype)


def make_ls_xprox(D, s, config: ADMMConfig, stream_dtype=None):
    """Shared least-squares x-prox: ``argmin 0.5||Dx-s||^2 +
    rho/2||x-(z-u)||^2`` with the rho-shift folded analytically.

    ``D`` and ``s`` are tensors on the solve's device.  Returns
    ``(prox_f, data)`` where ``data`` carries D, s, D^T s and the
    shape-appropriate solver: skinny/square works in the n-by-n Gram, fat
    (m < n) goes through Woodbury; static rho materializes one GEMV
    stream, dynamic rho keeps the eigenbasis.
    """
    m, n = D.shape
    data = {"D": D, "s": s, "Dts": D.T @ s}

    if m >= n:
        # Skinny/square: work with the n-by-n Gram (solvers/lasso.m:164-168).
        if config.dynamic_rho:
            data["sol"] = SymShiftSolver.from_matrix(D.T @ D)
            prox_f = _prox_f_adaptive
        else:
            data["Minv"] = SymShiftSolver.from_matrix(D.T @ D).materialize_inverse(
                config.rho
            )
            prox_f = _prox_f_static
    elif config.dynamic_rho:
        # Fat + adaptive rho: Woodbury through the m-by-m eigenbasis
        # (solvers/lasso.m:169-172; getProxOps.m:1198-1205).
        data["wood"] = WoodburySolver.from_matrix(D)
        prox_f = _prox_f_fat
    else:
        # Fat + static rho: fold the middle factor into one stream matrix
        # (two m-by-n GEMV streams per iteration).
        data["fat"] = FatShiftSolver.from_matrix(D, config.rho, stream_dtype)
        prox_f = _prox_f_fat_static

    return prox_f, data


def make_prox_ops(D, s, lam, config: ADMMConfig = ADMMConfig(), stream_dtype=None):
    """Build (prox_f, prox_g, obj, data) for LASSO (getProxOps.m:313-456)."""
    prox_f, data = make_ls_xprox(D, s, config, stream_dtype)
    data["lam"] = torch.as_tensor(lam, dtype=D.dtype, device=D.device)
    return prox_f, _prox_g, _obj, data


@timed_solver
def lasso(D=None, s=None, lam=None, config: ADMMConfig = ADMMConfig(), *,
          stream_dtype=None, use_fused_kernel=False, x0=None, z0=None, u0=None,
          parallel=False, device=None, **overrides) -> ADMMResults:
    """Solve LASSO (reference solvers/lasso.m:77).

    Constraint wiring matches lasso.m:226-239: A = 1, B = -1, c = 0 in R^n.
    ``use_fused_kernel`` routes the z-prox + dual update through the fused
    pass of ``ops/kernels.py`` (the Triton kernel on a CUDA device).

    ``D`` and ``s`` are numpy arrays or tensors; the solve runs in D's
    dtype on ``device``, or on D's device when D is a tensor, or on the
    CPU.  ``stream_dtype`` (ROADMAP K-ext-1), ``parallel=True`` (slice 10)
    and the zero-argument demo mode (slice 11) are not ported yet and
    raise ``NotImplementedError``.
    """
    if D is None:
        raise NotImplementedError(
            "lasso() demo mode needs the testers of ROADMAP.md queue 1, "
            "slice 11, which are not ported yet")
    if parallel:
        raise NotImplementedError(
            "lasso(parallel=True) needs the consensus runner of ROADMAP.md "
            "queue 1, slice 10, which is not ported yet")
    check_data_vector(D, s)
    config = merge_config(config, overrides, body="gemv")
    if device is None:
        device = D.device if isinstance(D, torch.Tensor) else torch.device("cpu")
    D = _to_device(D, device)
    s = _to_device(s, device, D.dtype)
    n = D.shape[1]
    prox_f, prox_g, obj, data = make_prox_ops(D, s, lam, config, stream_dtype)
    hooks = Hooks(obj=obj, fused_zu=_fused_zu if use_fused_kernel else None)
    return admm(
        prox_f, prox_g, config,
        A=1.0, B=-1.0, c=0.0, m=n, nA=n, nB=n,
        x0=x0, z0=z0, u0=u0,
        hooks=hooks, dtype=D.dtype, data=data, device=device,
    )
