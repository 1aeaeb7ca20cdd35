"""Elementwise proximal operators (port of ``admm_tpu/ops/prox.py``;
``soft_threshold`` only so far).  The fused soft-threshold + dual-update
kernel of the engine's performance mode lives in ``ops/kernels.py``."""

from __future__ import annotations

import torch


def soft_threshold(v, t):
    """sign(v) * max(|v| - t, 0).

    The reference's zminSoftThresholding (getProxOps.m:933-938), shared by
    basis pursuit, TV, lasso, covariance selection and LAD.  ``t`` may be a
    Python float or a 0-d tensor on ``v``'s device.
    """
    return torch.sign(v) * torch.clamp_min(torch.abs(v) - t, 0.0)
