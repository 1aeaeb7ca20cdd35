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
           ``ops/kernels.py``, which the engine runs with the whole tail
           of the step in one launch of a CUDA C++ kernel on the GPU.

Prox operators are module-level functions over a ``data`` dict of
tensors on the solve's device.
"""

from __future__ import annotations

import torch

from ..config import ADMMConfig
from ..engine import Hooks, admm
from ..graphs import capture_safe
from ..ops.kernels import fused_soft_threshold_dual, soft_threshold_pass
from ..ops.prox import soft_threshold
from ..ops.solve import FatShiftSolver, SymShiftSolver, WoodburySolver
from ..results import ADMMResults
from ..utils.profiling import span
from . import register
from ._common import bind_data, check_data_vector, merge_config, place_data, timed_solver


def _prox_f_static(x, z, u, rho, d):
    return d["Minv"] @ (d["Dts"] + rho * (z - u))


def _prox_f_adaptive(x, z, u, rho, d):
    return d["sol"].solve(d["Dts"] + rho * (z - u), rho)


def _prox_f_fat(x, z, u, rho, d):
    return d["wood"].solve(d["Dts"] + rho * (z - u), rho)


@capture_safe
def _prox_f_fat_static(x, z, u, rho, d):
    return d["fat"].solve(d["Dts"] + rho * (z - u))


@capture_safe
def _prox_g(x, z, u, rho, d):
    # zminSoftThresholding(u + x, lambda/rho) (getProxOps.m:455, 933-938)
    return soft_threshold(u + x, d["lam"] / rho)


@capture_safe
def _obj(x, z, d):
    # solvers/lasso.m objective: 1/2||Dx - s||^2 + lambda*||z||_1
    return 0.5 * torch.sum((d["D"] @ x - d["s"]) ** 2) + d["lam"] * torch.sum(torch.abs(z))


@capture_safe
@soft_threshold_pass(lambda d: d["lam"])
def _fused_zu(x, u, rho, d):
    # One-pass z-prox + dual update (Hooks.fused_zu; ops/kernels.py).  The
    # mark lets the engine run the whole step tail in one fused_zu_tail.
    return fused_soft_threshold_dual(x, u, d["lam"] / rho)


def make_ls_xprox(D, s, config: ADMMConfig, stream_dtype=None):
    """Shared least-squares x-prox: ``argmin 0.5||Dx-s||^2 +
    rho/2||x-(z-u)||^2`` with the rho-shift folded analytically.

    ``D`` and ``s`` are tensors on the solve's device.  Returns
    ``(prox_f, data)`` where ``data`` carries D, s, D^T s and the
    shape-appropriate solver: skinny/square works in the n-by-n Gram, fat
    (m < n) goes through Woodbury; static rho materializes one GEMV
    stream, dynamic rho keeps the eigenbasis.  ``stream_dtype`` reaches
    only the fat static-rho branch (``FatShiftSolver``).  Used by lasso,
    elastic net, NNLS and group lasso: they differ only in the z-prox.
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
    with span("admm_tpu_torch.setup"):
        prox_f, data = make_ls_xprox(D, s, config, stream_dtype)
        data["lam"] = torch.as_tensor(lam, dtype=D.dtype, device=D.device)
    return prox_f, _prox_g, _obj, data


@register("lasso")
def _registry_entry(D, s, lam, config=ADMMConfig(), device=None, **_):
    D, s, _device = place_data(D, s, device)
    return bind_data(*make_prox_ops(D, s, lam, config))


@timed_solver
def lasso(D=None, s=None, lam=None, config: ADMMConfig = ADMMConfig(), *,
          stream_dtype=None, use_fused_kernel=False, x0=None, z0=None, u0=None,
          parallel=False, nshards=None, mesh=None, device=None,
          **overrides) -> ADMMResults:
    """Solve LASSO (reference solvers/lasso.m:77).

    Constraint wiring matches lasso.m:226-239: A = 1, B = -1, c = 0 in R^n.
    ``use_fused_kernel`` routes the z-prox + dual update and the rest of
    the step's tail through ``ops/kernels.fused_zu_tail`` (one launch of
    the CUDA C++ kernel K1b a step on a CUDA device).

    ``D`` and ``s`` are numpy arrays or tensors; the solve runs in D's
    dtype on ``device``, or on D's device when D is a tensor, or on the
    CUDA device (``device.resolve_device``).  ``stream_dtype=torch.bfloat16`` stores the fat static-rho
    branch's two stream matrices in bf16 with f32 accumulation
    (``FatShiftSolver``; the K2 kernel on a CUDA device); the other
    branches ignore it, as in ``admm_tpu``.

    ``parallel=True`` mirrors the reference wrapper's options.parallel
    (lasso.m:148-150, 196-224): the solve runs as consensus ADMM with the
    rows in ``nshards`` stacked shards of ``mesh``
    (``parallel.consensus_lasso``).  Its x/u state is per-shard, so only
    the global ``z0`` passes through here; warm-start with
    ``consensus_lasso(xi0=, ui0=, z0=)``.  Called with no arguments it
    runs its tester's demo instance (``testers.problems``) on ``device``.
    """
    if D is None:
        # Zero-arg demo mode (reference solvers, e.g. lasso.m:122-129).
        from ..testers.problems import lassotest

        res, _test = lassotest(quiet=False, device=device)
        return res
    check_data_vector(D, s)
    config = merge_config(config, overrides, body="gemv")
    if parallel:
        if x0 is not None or u0 is not None:
            raise ValueError(
                "parallel=True runs consensus ADMM, whose x/u state is per-shard — use "
                "parallel.consensus_lasso(xi0=, ui0=, z0=) to warm-start it")
        if stream_dtype is not None or use_fused_kernel:
            raise ValueError("stream_dtype / use_fused_kernel are serial-path options; the "
                             "consensus solver does not consume them")
        from ..parallel import consensus_lasso

        return consensus_lasso(D, s, lam, config, mesh=mesh, nshards=nshards, z0=z0,
                               device=device)
    D, s, device = place_data(D, s, device)
    n = D.shape[1]
    prox_f, prox_g, obj, data = make_prox_ops(D, s, lam, config, stream_dtype)
    hooks = Hooks(obj=obj, fused_zu=_fused_zu if use_fused_kernel else None)
    return admm(
        prox_f, prox_g, config,
        A=1.0, B=-1.0, c=0.0, m=n, nA=n, nB=n,
        x0=x0, z0=z0, u0=u0,
        hooks=hooks, dtype=D.dtype, data=data, device=device,
    )
