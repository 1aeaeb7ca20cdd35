"""Elementwise proximal operators (port of ``admm_tpu/ops/prox.py``:
``soft_threshold``, ``block_soft_threshold`` and ``project_nonneg`` so
far).  The fused soft-threshold + dual-update kernel of the engine's
performance mode lives in ``ops/kernels.py``."""

from __future__ import annotations

import torch


def soft_threshold(v, t):
    """sign(v) * max(|v| - t, 0).

    The reference's zminSoftThresholding (getProxOps.m:933-938), shared by
    basis pursuit, TV, lasso, covariance selection and LAD.  ``t`` may be a
    Python float or a 0-d tensor on ``v``'s device.
    """
    return torch.sign(v) * torch.clamp_min(torch.abs(v) - t, 0.0)


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


def project_nonneg(v):
    """Projection onto the nonnegative orthant — LP/QP-standard z-prox
    (reference zminLinearProgram, getProxOps.m:1378-1382)."""
    return torch.clamp_min(v, 0.0)
