"""Nuclear-norm matrix completion (port of
``admm_tpu/models/matrixcompletion.py``):

    exact form (mu=None):   min ||Z||_*   s.t.  P_Omega(Z) = P_Omega(M)
    noisy form (mu given):  min ||Z||_* + (mu/2) ||P_Omega(Z - M)||_F^2

— recover a low-rank matrix from a subset Omega of its entries (Candes &
Recht 2009).  Beyond the reference; the sibling of ``rpca`` on the
engine's matrix iterates with A = 1, B = -1, c = 0 over the splitting
X = Z:

    X-step:  observed entries pinned to M, free entries copied from
             Z - U; in the noisy form the elementwise weighted average
             (rho (Z - U) + mu.mask.M) / (rho + mu.mask)
    Z-step:  SVT(X + U, 1/rho)          (singular value thresholding)
    U    +=  X - Z

The SVT is the per-step heavy op: one thin SVD (``ops/prox.thin_svd``),
or at ``prox_method='rsvd'`` the randomized-range sketch of
Halko-Martinsson-Tropp (``randomized_svt``), exact whenever the
thresholded iterate has rank <= k.  Its Gaussian test matrix G is drawn
once at setup from ``seed`` (a CPU ``torch.Generator``: the port's own
random stream) and kept in ``data["G"]``; ``admm_tpu`` draws the same
shape from ``PRNGKey(seed)`` on every call, so G is a constant of the
solve in both.  This module also holds ``svt`` and ``randomized_svt``,
which ``rpca`` shares.
"""

from __future__ import annotations

import functools

import torch

from ..config import ADMMConfig
from ..device import resolve_device
from ..engine import Hooks, admm
from ..ops.prox import thin_svd
from ..results import ADMMResults
from . import register
from ._common import as_tensor, bind_data, merge_config, timed_solver


def _prox_f_exact(X, Z, U, rho, d):
    # Projection onto {X : X_Omega = M_Omega}: pin observed entries, copy
    # the free ones from the target Z - U.
    return torch.where(d["mask"] != 0, d["M"], Z - U)


def _prox_f_noisy(X, Z, U, rho, d):
    # argmin (mu/2)||mask*(X - M)||_F^2 + (rho/2)||X - (Z - U)||_F^2:
    # elementwise weighted average (off Omega the mu term vanishes).
    w = d["mu"] * d["mask"]
    return (rho * (Z - U) + w * d["M"]) / (rho + w)


def svt(V, thresh):
    """Singular value thresholding: U max(s - thresh, 0) V^T."""
    u_, s_, vt = thin_svd(V)
    s_ = torch.clamp_min(s_ - thresh, 0.0)
    return (u_ * s_.unsqueeze(-2)) @ vt


def randomized_svt(V, thresh, G, power_iters: int):
    """Randomized-range SVT (Halko-Martinsson-Tropp): sketch the
    k-dimensional range of V with the (n, k) test matrix G, GEMMs and
    QR, and take the SVD of the (k, n) sketch only.  Exact when
    rank(SVT(V)) <= k; shared by ``rpca`` and matrix completion."""
    Y = V @ G
    for _ in range(power_iters):
        # Subspace iteration sharpens the range; QR keeps it sane.
        Y, _ = torch.linalg.qr(Y)
        Y = V @ (V.mT @ Y)
    Q, _ = torch.linalg.qr(Y)              # (m, k) orthonormal range
    ub, sb, vtb = thin_svd(Q.mT @ V)       # SVD of the (k, n) sketch
    sb = torch.clamp_min(sb - thresh, 0.0)
    return (Q @ (ub * sb.unsqueeze(-2))) @ vtb


def sketch_matrix(n: int, k: int, seed: int, *, dtype, device):
    """The (n, k) Gaussian test matrix of ``randomized_svt``, drawn in f64
    from a CPU ``torch.Generator`` seeded with ``seed`` and cast to
    ``dtype`` on ``device``."""
    gen = torch.Generator().manual_seed(int(seed))
    return torch.randn((n, k), generator=gen, dtype=torch.float64).to(device=device,
                                                                      dtype=dtype)


def sketch_rank(shape, rank, oversample: int) -> int:
    """k of the sketch: ``rank + oversample``, at most min(shape)."""
    return min(int(rank) + int(oversample), min(shape))


def _prox_g(X, Z, U, rho, d):
    return svt(X + U, 1.0 / rho)


def _rsvd_prox(X, Z, U, rho, d, *, power_iters):
    return randomized_svt(X + U, 1.0 / rho, d["G"], power_iters)


def _obj_exact(X, Z, d):
    return torch.sum(thin_svd(Z, values_only=True))


def _obj_noisy(X, Z, d):
    fit = d["mask"] * (X - d["M"])
    return torch.sum(thin_svd(Z, values_only=True)) + 0.5 * d["mu"] * torch.sum(fit * fit)


def make_prox_ops(M, mask, mu=None, config: ADMMConfig = ADMMConfig(), *,
                  prox_method: str = "exact", rank=None, oversample: int = 10,
                  power_iters: int = 2, seed: int = 0):
    """Build (prox_f, prox_g, obj, data) for matrix completion from the
    tensor ``M`` (its device and dtype are the solve's).

    ``mask`` is the 0/1 (or bool) observation indicator; entries of ``M``
    outside the mask are ignored.  ``mu=None`` selects the exact-constraint
    form, a positive ``mu`` the noisy quadratic-fit form.
    ``prox_method='rsvd'`` swaps the full SVD for the randomized-range SVT
    (needs ``rank``, an upper bound on the completed rank; ``oversample``
    columns are added; G in ``data["G"]``)."""
    if M.ndim != 2:
        raise ValueError(f"M must be a matrix, got shape {tuple(M.shape)}")
    mask = as_tensor(mask)
    if tuple(mask.shape) != tuple(M.shape):
        raise ValueError(
            f"mask must match M's shape {tuple(M.shape)}, got {tuple(mask.shape)}")
    mask = mask.to(device=M.device, dtype=M.dtype)
    # Zero the unobserved entries so the pinned values are well-defined
    # regardless of what the caller left there.
    data = {"M": M * mask, "mask": mask}
    if mu is None:
        prox_f, obj = _prox_f_exact, _obj_exact
    else:
        if float(mu) <= 0.0:
            raise ValueError(f"mu must be positive (or None), got {mu}")
        data["mu"] = torch.as_tensor(mu, dtype=M.dtype, device=M.device)
        prox_f, obj = _prox_f_noisy, _obj_noisy
    if prox_method == "exact":
        prox_g = _prox_g
    elif prox_method == "rsvd":
        if rank is None:
            raise ValueError("prox_method='rsvd' needs rank= (an upper "
                             "bound on the completed rank)")
        k = sketch_rank(M.shape, rank, oversample)
        data["G"] = sketch_matrix(M.shape[1], k, seed, dtype=M.dtype, device=M.device)
        prox_g = functools.partial(_rsvd_prox, power_iters=int(power_iters))
    else:
        raise ValueError(
            f"prox_method must be 'exact' or 'rsvd', got {prox_method!r}")
    return prox_f, prox_g, obj, data


@register("matrixcompletion")
def _registry_entry(M, mask, mu=None, config=ADMMConfig(), prox_method="exact",
                    rank=None, device=None, **_):
    M = as_tensor(M).to(resolve_device(device, M, mask))
    pf, pg, obj, data = make_prox_ops(M, mask, mu, config, prox_method=prox_method,
                                      rank=rank)
    return bind_data(pf, pg, obj, data)


@timed_solver
def matrixcompletion(M, mask, mu=None, config: ADMMConfig = ADMMConfig(), *,
                     prox_method: str = "exact", rank=None, oversample: int = 10,
                     power_iters: int = 2, seed: int = 0, x0=None, z0=None, u0=None,
                     device=None, **overrides) -> ADMMResults:
    """Complete the partially observed matrix ``M`` (observation indicator
    ``mask``) by nuclear-norm minimization.

    ``results.zopt`` is the completed low-rank matrix (the Z iterate
    carries the spectral structure; X pins the observed entries).
    Constraint wiring: A = 1, B = -1, c = 0 over matrix iterates.  ``M``
    is a numpy array or a tensor; the solve runs in its dtype on
    ``device``, or on M's device when M is a tensor, or on the CUDA device
    (``device.resolve_device``).
    """
    config = merge_config(config, overrides, body="heavy")
    device = resolve_device(device, M, mask)
    M = as_tensor(M).to(device)
    prox_f, prox_g, obj, data = make_prox_ops(
        M, mask, mu, config, prox_method=prox_method, rank=rank,
        oversample=oversample, power_iters=power_iters, seed=seed)
    return admm(
        prox_f, prox_g, config,
        A=1.0, B=-1.0, c=0.0, shape_x=tuple(M.shape), shape_z=tuple(M.shape),
        x0=x0, z0=z0, u0=u0,
        hooks=Hooks(obj=obj), dtype=M.dtype, data=data, device=device,
    )
