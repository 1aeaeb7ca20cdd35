"""The engine's fused z-prox + dual-update pass (port of
``admm_tpu/ops/kernels.py``).

The ADMM tail of every iteration — z-prox (soft-threshold) followed by the
dual update — reads x and u and writes z and u:

    z = sign(x + u) * max(|x + u| - t, 0)
    u = u + x - z

On a CUDA tensor ``fused_soft_threshold_dual`` launches the hand-written
Triton kernel of ``ops/triton_fused_zu.py``; on a CPU tensor it runs the
plain PyTorch version ``_fused_torch``.  There is no fallback between the
two: a CUDA tensor never reaches ``_fused_torch``, and a kernel that fails
to build or launch raises.
"""

from __future__ import annotations

import torch


def _fused_torch(x, u, t):
    """Plain PyTorch version (mirrors ``admm_tpu.ops.kernels._fused_jnp``)."""
    v = x + u
    z = torch.sign(v) * torch.clamp_min(torch.abs(v) - t, 0.0)
    return z, u + x - z


def fused_soft_threshold_dual(x, u, t):
    """Fused  z = soft_threshold(x + u, t);  u' = u + x - z.

    ``x`` and ``u`` are 1-D tensors of one float dtype on one device.  On
    the GPU ``t`` must be a 0-d tensor of that dtype on that device (the
    kernel reads it through a pointer, so the host never syncs for it); on
    the CPU it may also be a Python float.  Returns new tensors ``(z, u')``;
    the inputs are not modified.
    """
    if x.device.type == "cpu":
        return _fused_torch(x, u, t)
    if x.device.type != "cuda":
        raise ValueError(f"fused_soft_threshold_dual: unsupported device {x.device}")
    if not (isinstance(t, torch.Tensor) and t.ndim == 0):
        raise TypeError("fused_soft_threshold_dual on CUDA needs t as a 0-d tensor")
    if x.dtype not in (torch.float32, torch.float64):
        raise TypeError(f"fused_soft_threshold_dual: unsupported dtype {x.dtype}")
    for name, a in (("u", u), ("t", t)):
        if a.device != x.device or a.dtype != x.dtype:
            raise ValueError(
                f"fused_soft_threshold_dual: {name} is {a.dtype} on {a.device}, "
                f"x is {x.dtype} on {x.device}")
    if x.ndim != 1 or u.shape != x.shape:
        raise ValueError(
            f"fused_soft_threshold_dual: need 1-D x and u of one shape, got "
            f"{tuple(x.shape)} and {tuple(u.shape)}")
    from .triton_fused_zu import launch

    x = x.contiguous()
    u = u.contiguous()
    z = torch.empty_like(x)
    unew = torch.empty_like(x)
    launch(x, u, t, z, unew)
    fused_soft_threshold_dual.launches += 1
    return z, unew


# Launches of the Triton kernel made by the wrapper in this process.
# Callers reset it to 0 and read it back to show that a run went through
# the kernel; the CPU path never counts.
fused_soft_threshold_dual.launches = 0
