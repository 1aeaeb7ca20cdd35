"""Total variation minimization (1-D denoising) (port of
``admm_tpu/models/totalvariation.py``):

    min 1/2 ||x - s||^2 + lambda ||z||_1   s.t.   D x - z = 0

with D the bidiagonal difference operator (solvers/totalvariation.m:127).

Reference: solvers/totalvariation.m (wrapper; A = D, B = -1 at :151-156)
and getProxOps.m case 'totalvariation' (:145-199) with x-prox
xminTotalVariation (getProxOps.m:1044-1048).

x-update:  (I + rho D^T D)^{-1} (s + rho D^T (z - u)), by a dense inverse
           from one eigendecomposition ('dense') or by cyclic reduction of
           the fixed tridiagonal system ('cr', 'cr_masked'; on a CUDA
           device through the kernel of ``ops/tridiag.cr_solve``).
z-update:  soft_threshold(u + D x, lambda / rho)

D and D^T apply matrix-free in O(n) (``linop.DiffOp``).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..config import ADMMConfig
from ..device import resolve_device
from ..engine import Hooks, admm
from ..linop import DiffOp
from ..ops.prox import soft_threshold
from ..ops.tridiag import CyclicReductionSolver
from ..results import ADMMResults
from . import register
from ._common import as_tensor, bind_data, merge_config, timed_solver


def _prox_f_static(x, z, u, rho, d):
    return d["Minv"] @ (d["s"] + rho * d["D"].rmv(z - u))


def _prox_f_cr(x, z, u, rho, d):
    # O(n log n) cyclic-reduction solve of the fixed tridiagonal system
    # (ops/tridiag.py) in place of the O(n^2) dense apply at large n.
    return d["cr"].solve(d["s"] + rho * d["D"].rmv(z - u))


def _prox_f_cr_plain(x, z, u, rho, d):
    # _prox_f_cr with the b-phase forced through the plain PyTorch version
    # on any device (``totalvariation(_plain_cr=True)``).
    return d["cr"].solve(d["s"] + rho * d["D"].rmv(z - u), plain=True)


def _prox_f_adaptive(x, z, u, rho, d):
    b = d["s"] + rho * d["D"].rmv(z - u)
    return d["V"] @ ((d["V"].T @ b) / (1.0 + rho * d["w"]))


def _prox_g(x, z, u, rho, d):
    # The engine passes raw x; the reference z-prox applies D itself
    # (getProxOps.m case :145-199).
    return soft_threshold(u + d["D"].mv(x), d["lam"] / rho)


def _prox_g_relaxed(Axhat, z, u, rho, d):
    # Under relaxation the engine hands Axhat (already in D-space).
    return soft_threshold(u + Axhat, d["lam"] / rho)


def _obj(x, z, d):
    return 0.5 * torch.sum((x - d["s"]) ** 2) + d["lam"] * torch.sum(torch.abs(z))


def tv_system(n, rho):
    """The x-update's matrix I + rho D^T D as (dl, d, du) for
    ``CyclicReductionSolver.from_tridiag``: tridiag(-rho, 1 + rho*[1,2,...,2],
    -rho), since D^T D = I + diag(0,1,..,1) - U - U^T for the DiffOp
    stencil."""
    diag = 1.0 + rho * np.r_[1.0, 2.0 * np.ones(n - 1)]
    off = -rho * np.ones(n)
    return np.r_[0.0, off[1:]], diag, np.r_[off[:-1], 0.0]


def _resolve_solver(solver, n, config):
    """The ``'auto'`` choice of ``admm_tpu``: cyclic reduction for
    n > 2048 with static rho, else dense."""
    if solver == "auto":
        return "cr" if (n > 2048 and not config.dynamic_rho) else "dense"
    return solver


def make_prox_ops(s, lam, config: ADMMConfig = ADMMConfig(), solver: str = "auto"):
    """Build (prox_f, prox_g, obj, data, D) for TV (getProxOps.m:145-199).

    ``s`` is a 1-D tensor; the operands land on its device in its dtype.
    ``solver``: 'dense' diagonalizes D^T D once (O(n^2) apply per
    iteration); 'cr' precomputes the cyclic-reduction elimination of the
    fixed tridiagonal system, with ``admm_tpu``'s hybrid dense tail
    (cutoff 1023) for n > 16384, below that the pure masked form;
    'cr_masked' runs every level masked; 'auto' picks 'cr' for n > 2048
    with static rho.  'cr_packed' (``admm_tpu``'s measured negative) is
    not ported and raises.
    """
    n = s.shape[0]
    D = DiffOp(n)
    data = {"s": s, "lam": torch.as_tensor(lam, dtype=s.dtype, device=s.device), "D": D}

    solver = _resolve_solver(solver, n, config)
    if solver == "cr_packed":
        raise NotImplementedError(
            "solver='cr_packed' (admm_tpu's PackedCyclicReductionSolver, its "
            "measured negative result) is not ported; see ROADMAP.md queue 1, "
            "slice 6")
    if solver in ("cr", "cr_masked") and config.dynamic_rho:
        raise ValueError("cyclic-reduction TV requires static rho")

    if solver in ("cr", "cr_masked"):
        # admm_tpu's gate: the hybrid tail pays off only at depth
        # (n > 16384); its batched lanes (not ported) always take it.
        cutoff = 1023 if (solver == "cr" and n > 16384) else None
        data["cr"] = CyclicReductionSolver.from_tridiag(
            *tv_system(n, config.rho), dense_cutoff=cutoff, device=s.device,
            dtype=s.dtype)
        prox_f = _prox_f_cr
    elif solver == "dense":
        Dd = D.dense(s.dtype, s.device)
        DtD = Dd.T @ Dd  # dense D^T D (tridiagonal), built once at setup
        DtD = 0.5 * (DtD + DtD.T)
        w, V = torch.linalg.eigh(DtD)
        if config.dynamic_rho:
            data["V"], data["w"] = V, w
            prox_f = _prox_f_adaptive
        else:
            data["Minv"] = (V / (1.0 + config.rho * w)[None, :]) @ V.T
            prox_f = _prox_f_static
    else:
        raise ValueError(f"unknown TV solver {solver!r}")

    prox_g = _prox_g if config.relax == 1.0 else _prox_g_relaxed
    return prox_f, prox_g, _obj, data, D


@register("totalvariation")
def _registry_entry(s, lam, config=ADMMConfig(), device=None, **_):
    s = as_tensor(s).to(resolve_device(device, s))
    pf, pg, obj, data, _D = make_prox_ops(s, lam, config)
    return bind_data(pf, pg, obj, data)


@timed_solver
def totalvariation(s=None, lam=None, config: ADMMConfig = ADMMConfig(), *,
                   solver: str = "auto", x0=None, z0=None, u0=None,
                   device=None, _plain_cr=False, **overrides) -> ADMMResults:
    """Solve 1-D TV denoising (reference solvers/totalvariation.m:62).

    Constraint wiring matches totalvariation.m:151-156: A = D, B = -1, c = 0.
    ``s`` is a numpy array or a tensor; the solve runs in its dtype on
    ``device``, or on s's device when s is a tensor, or on the CUDA device
    (``device.resolve_device``).

    ``_plain_cr`` is for tests only: it runs the cyclic-reduction b-phase
    through the plain PyTorch version even on a CUDA device, so that a
    run can be held against the kernel's.  The zero-argument demo mode
    (slice 11) is not ported yet and raises ``NotImplementedError``.
    """
    if s is None:
        raise NotImplementedError(
            "totalvariation() demo mode needs the testers of ROADMAP.md "
            "queue 1, slice 11, which are not ported yet")
    device = resolve_device(device, s)
    s = as_tensor(s).to(device)
    n = s.shape[0]
    # Apply overrides BEFORE resolving the solve path: an override like
    # adaptive=True flips dynamic_rho, which flips the auto dense/cr
    # choice.  merge_config would resolve unroll='auto' too early, so
    # replace directly and resolve once the path is known.
    if overrides:
        config = dataclasses.replace(config, **overrides)
    resolved = _resolve_solver(solver, n, config)
    # The dense body unrolls like any GEMV solver; the cyclic-reduction
    # body takes the balanced default (admm_tpu's choice).
    config = merge_config(config, {},
                          body="gemv" if resolved == "dense" else "default")
    prox_f, prox_g, obj, data, D = make_prox_ops(s, lam, config, resolved)
    if _plain_cr:
        if prox_f is not _prox_f_cr:
            raise ValueError("_plain_cr needs a cyclic-reduction solver")
        prox_f = _prox_f_cr_plain
    return admm(
        prox_f, prox_g, config,
        A=D, B=-1.0, c=0.0, m=n, nA=n, nB=n,
        x0=x0, z0=z0, u0=u0,
        hooks=Hooks(obj=obj), dtype=s.dtype, data=data, device=device,
    )
