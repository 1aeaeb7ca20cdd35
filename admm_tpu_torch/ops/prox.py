"""Elementwise proximal operators (port of ``admm_tpu/ops/prox.py``:
``soft_threshold``, ``asymmetric_soft_threshold``, ``block_soft_threshold``,
``hinge_prox``, ``zero_one_prox``, ``huber_prox`` and ``project_nonneg``
so far).  The fused soft-threshold + dual-update kernel of the engine's
performance mode lives in ``ops/kernels.py``.

Thresholds, ``rho`` and the SVM's ``C`` may be Python floats or 0-d
tensors on the operand's device; no function here reads a tensor back to
the host, so a solve's sub-steps stay free of synchronising calls."""

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
    per-group.  ``admm_tpu``'s segment sum is an ``index_add_`` here (on
    the card its atomics add in no fixed order).  Beyond the reference
    (its shrinkage family stops at elementwise soft-thresholding,
    getProxOps.m:933-938).
    """
    norm2 = v.new_zeros(num_groups).index_add_(0, gid, v * v)
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
