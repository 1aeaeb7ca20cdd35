"""Proximal operators (port of ``admm_tpu/ops/prox.py``, all of it).  The
fused soft-threshold + dual-update kernel of the engine's performance mode
lives in ``ops/kernels.py``.

Thresholds, ``rho`` and the SVM's ``C`` may be Python floats or 0-d
tensors on the operand's device.  No element-wise function here reads a
tensor back to the host, so a solve's sub-steps stay free of
synchronising calls.  The two spectral ones, ``psd_project`` and
``covsel_eig_prox``, run ``torch.linalg.eigh`` (cuSOLVER on the card,
see ``sym_eigh``), which checks its ``info`` on the host: one
synchronising call each."""

from __future__ import annotations

import torch


def soft_threshold(v, t):
    """sign(v) * max(|v| - t, 0).

    The reference's zminSoftThresholding (getProxOps.m:933-938), shared by
    basis pursuit, TV, lasso, covariance selection and LAD.  ``t`` may be a
    Python float or a 0-d tensor on ``v``'s device.
    """
    return torch.sign(v) * torch.clamp_min(torch.abs(v) - t, 0.0)


def asymmetric_soft_threshold(v, t_pos, t_neg):
    """Two-sided shrinkage with different thresholds per sign:

        v - t_pos   if v >  t_pos
        v + t_neg   if v < -t_neg
        0           otherwise

    The prox of the pinball (quantile) loss ``tau*max(v,0) +
    (1-tau)*max(-v,0)`` at thresholds ``(tau/rho, (1-tau)/rho)``.
    ``t_pos = t_neg`` recovers :func:`soft_threshold`.  Beyond the
    reference (its shrinkage family is symmetric, getProxOps.m:933-938).
    """
    return torch.clamp_min(v - t_pos, 0.0) - torch.clamp_min(-v - t_neg, 0.0)


def block_soft_threshold(v, t, gid, num_groups):
    """Group-wise shrinkage: each group g of ``v`` (membership ``gid``, an
    int64 tensor on ``v``'s device) scales by max(0, 1 - t_g / ||v_g||_2).

    The prox of ``sum_g t_g ||v_g||_2`` (group lasso).  ``t`` is scalar or
    per-group.  ``admm_tpu``'s segment sum is an ``index_add`` here (on
    the card its atomics add in no fixed order).  Beyond the reference
    (its shrinkage family stops at elementwise soft-thresholding,
    getProxOps.m:933-938).
    """
    # Out of place: under vmap (batched lanes) an in-place add into the
    # fresh unbatched zeros would be refused.
    norm2 = v.new_zeros(num_groups).index_add(0, gid, v * v)
    norm = torch.sqrt(norm2)
    t = torch.broadcast_to(torch.as_tensor(t, dtype=v.dtype, device=v.device),
                           (num_groups,))
    # where-guard: a zero-norm group must scale by 0, not NaN.
    scale = torch.clamp_min(1.0 - t / torch.where(norm > 0, norm, 1.0), 0.0)
    scale = torch.where(norm > 0, scale, 0.0)
    return scale[gid] * v


def hinge_prox(Dx_plus_u, ell, C, rho):
    """Hinge-loss z-prox for the linear SVM.

    z = (Dx+u) + ell * max(min(1 - ell*(Dx+u), C/rho), 0)
    (reference zminLinearSVM, getProxOps.m:1084-1103).
    """
    v = ell * Dx_plus_u
    return Dx_plus_u + ell * torch.clamp_min(torch.clamp(1.0 - v, max=C / rho), 0.0)


def zero_one_prox(Dx_plus_u, ell, C, rho):
    """0-1-loss z-prox for unwrapped-ADMM linear SVM.

    y_i = s_i where s_i >= 1 or s_i < 1 - sqrt(2/t) (t = rho/C), else 1;
    returns ell * y for s = ell*(Dx+u)
    (reference minz01, getProxOps.m:1158-1180 via zminLinearSVM:1100).
    Note: nonconvex; valid only with the transpose-reduction x-update.
    """
    s = ell * Dx_plus_u
    t = rho / C
    # A 0-d tensor t stays on its device; a Python float becomes a CPU
    # scalar, which any device's elementwise ops take as a number.
    keep = (s >= 1.0) | (s < 1.0 - torch.sqrt(torch.as_tensor(2.0 / t, dtype=s.dtype)))
    y = torch.where(keep, s, 1.0)
    return ell * y


def huber_prox(Ax, u, s, rho):
    """Huber-fitting z-prox.

    z = 1/(1+rho) * (rho*v + S(v, 1 + 1/rho)), v = Ax + u - s
    (reference zminHuberSoftThresholding, getProxOps.m:1529-1539).
    """
    v = Ax + u - s
    return (rho * v + soft_threshold(v, 1.0 + 1.0 / rho)) / (1.0 + rho)


def project_nonneg(v):
    """Projection onto the nonnegative orthant — LP/QP-standard z-prox
    (reference zminLinearProgram, getProxOps.m:1378-1382)."""
    return torch.clamp_min(v, 0.0)


def project_box(v, lb, ub):
    """Projection onto {lb <= z <= ub} — bounded-QP z-prox
    (reference zminQuadraticProgramBounded, getProxOps.m:1470-1474)."""
    return torch.minimum(ub, torch.maximum(lb, v))


def _sym(W):
    return 0.5 * (W + W.transpose(-1, -2))


# On a CUDA device torch.linalg.eigh takes cuSOLVER's Jacobi syevj for a
# float32 matrix of order 32 to 512 (syevjBatched for batches of order 32
# or less), and syevd otherwise.  syevj's float32 eigenpairs carry an
# error that accumulates over the steps of a solve: a float32 max-cut SDP
# (n = 512) ends far further from float64 with them than with LAPACK's
# float32 syevd or with the route below (experiments/eigh_route_probe.py
# measures each route).
JACOBI_MAX_N = 512


def sym_eigh(W):
    """(eigenvalues ascending, eigenvectors) of the symmetric part of W,
    the one eigendecomposition of both spectral proxes.

    A float32 matrix on a CUDA device of order up to ``JACOBI_MAX_N``
    (the orders torch would hand to syevj) is decomposed in float64
    (cuSOLVER's syevd) and its factors rounded back to float32; every
    other input goes to ``torch.linalg.eigh`` as it is.  Either way the
    call reads cuSOLVER's ``info`` back to the host once."""
    W = _sym(W)
    if W.is_cuda and W.dtype == torch.float32 and W.shape[-1] <= JACOBI_MAX_N:
        e, Q = torch.linalg.eigh(W.double())
        return e.float(), Q.float()
    return torch.linalg.eigh(W)


# A float32 SVD on a CUDA device (``thin_svd``) is taken in float64: on an
# H100, one f32 SVT of the robust-PCA and completion iterates lands
# 3.5e-5-1.3e-4 from LAPACK's f64 through torch's own choice, the Jacobi
# gesvdj, and 7.6e-8-2.3e-7 through the f64 decomposition; gesvda is as
# accurate and 4.8-7x faster on those, but fails to converge on a matrix
# with repeated singular values, which an SVT's low-rank output is, and
# gesvd lands 4.6e-7-1.9e-6 from it at 0.9-2.5x the f64 time (chip_smoke.py
# (z11)-(z12) print every route).


def thin_svd(V, values_only=False):
    """The thin SVD ``(U, s, Vh)`` of V (leading batch dimensions allowed),
    or only ``s`` with ``values_only``: the one SVD of the spectral proxes
    of robust PCA and matrix completion.  A float32 matrix on a CUDA device
    is decomposed in float64 and its factors rounded back to float32;
    every other input goes to ``torch.linalg.svd`` as it is.
    ``torch.linalg.svd`` has no ``_ex`` form: on a CUDA device the call
    reads cuSOLVER's ``info`` back to the host."""
    if V.is_cuda and V.dtype == torch.float32:
        out = thin_svd(V.double(), values_only)
        return out.float() if values_only else tuple(t.float() for t in out)
    if values_only:
        return torch.linalg.svdvals(V)
    return torch.linalg.svd(V, full_matrices=False)


def psd_project(W):
    """Projection onto the positive-semidefinite cone: symmetrize, then
    clamp the spectrum at zero (Higham 1988).  SDP z-prox; takes leading
    batch dimensions.  Beyond-reference family — the reference's closest
    analog is the covariance-selection spectral prox (getProxOps.m:1487-1496),
    which uses the same eigh+reconstruct shape."""
    e, Q = sym_eigh(W)
    return (Q * torch.clamp_min(e, 0.0).unsqueeze(-2)) @ Q.transpose(-1, -2)


def covsel_eig_prox(ZU_minus_S_scaled, rho, weight=1.0):
    """Covariance-selection x-prox.

    Given W = rho*(Z - U) - S, eigendecompose W = Q diag(e) Q^T and return
    X = Q diag((e + sqrt(e^2 + 4 rho w)) / (2 rho)) Q^T
    (reference xminCovarianceSelection, getProxOps.m:1487-1496; w = 1).

    W is symmetric only up to rounding (X comes from a Q diag Q^T
    reconstruction), and ``torch.linalg.eigh`` reads one triangle, where
    ``jnp.linalg.eigh`` symmetrizes its input first: W is symmetrized here
    so that both packages decompose the same matrix.

    ``weight`` scales the logdet term: the prox of
    tr(S X) - w logdet X solves rho X - w X^{-1} = W, whose spectral
    root swaps 4 rho for 4 rho w (the consensus covsel split's per-shard
    prox).
    """
    e, Q = sym_eigh(ZU_minus_S_scaled)
    diag = (e + torch.sqrt(e * e + (4.0 * weight) * rho)) / (2.0 * rho)
    return (Q * diag.unsqueeze(-2)) @ Q.transpose(-1, -2)
