"""Robust PCA (principal component pursuit; port of
``admm_tpu/models/rpca.py``):

    min ||L||_* + lam ||S||_1   s.t.   L + S = M

— decompose a matrix into low-rank + sparse (Candes, Li, Ma, Wright
2011).  Beyond the reference; the classic ADMM splitting on the engine's
matrix iterates with A = B = +1 and c = M:

    L-step:  SVT(M - S - U, 1/rho)       (singular value thresholding)
    S-step:  soft_threshold(M - L - U, lam/rho)
    U     += L + S - M

The SVT is one thin SVD per step (``matrixcompletion.svt``), or at
``prox_method='rsvd'`` the randomized-range SVT
(``matrixcompletion.randomized_svt``) with its test matrix G drawn once
at setup from ``seed`` and kept in ``data["G"]``.  lam defaults to the
theory value 1/sqrt(max(m, n)) under which exact recovery holds for
incoherent low-rank + random sparse inputs.
"""

from __future__ import annotations

import functools

import torch

from ..config import ADMMConfig
from ..device import resolve_device
from ..engine import Hooks, admm
from ..ops.prox import soft_threshold, thin_svd
from ..results import ADMMResults
from . import register
from ._common import as_tensor, bind_data, merge_config, timed_solver
from .matrixcompletion import randomized_svt, sketch_matrix, sketch_rank, svt


def _prox_f(L, S, U, rho, d):
    # L-step: argmin ||L||_* + rho/2 ||L - (M - S - U)||_F^2 = SVT at 1/rho.
    return svt(d["M"] - S - U, 1.0 / rho)


def _rsvd_prox(L, S, U, rho, d, *, power_iters):
    return randomized_svt(d["M"] - S - U, 1.0 / rho, d["G"], power_iters)


def _prox_g(L, S, U, rho, d):
    # S-step: elementwise shrinkage toward M - L - U at lam/rho.
    return soft_threshold(d["M"] - L - U, d["lam"] / rho)


def _obj(L, S, d):
    return torch.sum(thin_svd(L, values_only=True)) + d["lam"] * torch.sum(torch.abs(S))


def make_prox_ops(M, lam=None, config: ADMMConfig = ADMMConfig(), *,
                  prox_method: str = "exact", rank=None, oversample: int = 10,
                  power_iters: int = 2, seed: int = 0):
    """Build (prox_f, prox_g, obj, data) for robust PCA from the tensor
    ``M`` (its device and dtype are the solve's).

    ``lam`` defaults to 1/sqrt(max(M.shape)) (the exact-recovery theory
    value) and rides in ``data``.  ``prox_method='rsvd'`` swaps the full
    SVD for the randomized-range SVT (needs ``rank``, an upper bound on
    the rank of L; ``oversample`` columns are added; G in ``data["G"]``)."""
    if M.ndim != 2:
        raise ValueError(f"M must be a matrix, got shape {tuple(M.shape)}")
    if lam is None:
        lam = 1.0 / float(max(M.shape)) ** 0.5
    data = {"M": M, "lam": torch.as_tensor(lam, dtype=M.dtype, device=M.device)}
    if prox_method == "exact":
        prox_f = _prox_f
    elif prox_method == "rsvd":
        if rank is None:
            raise ValueError("prox_method='rsvd' needs rank= (an upper "
                             "bound on rank(L))")
        k = sketch_rank(M.shape, rank, oversample)
        data["G"] = sketch_matrix(M.shape[1], k, seed, dtype=M.dtype, device=M.device)
        prox_f = functools.partial(_rsvd_prox, power_iters=int(power_iters))
    else:
        raise ValueError(
            f"prox_method must be 'exact' or 'rsvd', got {prox_method!r}")
    return prox_f, _prox_g, _obj, data


@register("rpca")
def _registry_entry(M, lam=None, config=ADMMConfig(), prox_method="exact", rank=None,
                    device=None, **_):
    M = as_tensor(M).to(resolve_device(device, M))
    pf, pg, obj, data = make_prox_ops(M, lam, config, prox_method=prox_method, rank=rank)
    return bind_data(pf, pg, obj, data)


@timed_solver
def rpca(M, lam=None, config: ADMMConfig = ADMMConfig(), *,
         prox_method: str = "exact", rank=None, oversample: int = 10,
         power_iters: int = 2, seed: int = 0,
         x0=None, z0=None, u0=None, device=None, **overrides) -> ADMMResults:
    """Decompose ``M`` into low-rank ``xopt`` (= L) + sparse ``zopt``
    (= S) by principal component pursuit.

    Constraint wiring: A = 1, B = +1, c = M over matrix iterates.  ``M``
    is a numpy array or a tensor; the solve runs in its dtype on
    ``device``, or on M's device when M is a tensor, or on the CUDA device
    (``device.resolve_device``).
    """
    config = merge_config(config, overrides, body="heavy")
    device = resolve_device(device, M)
    M = as_tensor(M).to(device)
    prox_f, prox_g, obj, data = make_prox_ops(
        M, lam, config, prox_method=prox_method, rank=rank,
        oversample=oversample, power_iters=power_iters, seed=seed)
    return admm(
        prox_f, prox_g, config,
        A=1.0, B=1.0, c=M, shape_x=tuple(M.shape), shape_z=tuple(M.shape),
        x0=x0, z0=z0, u0=u0,
        hooks=Hooks(obj=obj), dtype=M.dtype, data=data, device=device,
    )
