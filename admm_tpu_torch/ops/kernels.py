"""The engine's fused z-prox + dual-update pass (port of
``admm_tpu/ops/kernels.py``), alone (K1) or with the whole tail of the
step (K1b).

The ADMM tail of every iteration — z-prox (soft-threshold) followed by the
dual update — reads x and u and writes z and u:

    z = sign(x + u) * max(|x + u| - t, 0)
    u = u + x - z

``fused_soft_threshold_dual`` is that pass (the ``Hooks.fused_zu``
contract).  ``fused_zu_tail`` is one whole engine tail of the plain
splitting A = I, B = -I, c = 0 around it: the pass with t = lam / rho, the
residual norms, Boyd errors, stop and divergence flags, the history write
and the unroll-freeze select, with x, z, u and the step state updated in
place.  The engine takes it for a ``fused_zu`` hook marked with
``soft_threshold_pass``.

On CUDA tensors both launch the hand-written CUDA C++ kernel of
``csrc/zu_tail.cu`` (z/u mode and tail mode; built by ``ops/_cuda.py``);
on CPU tensors they run the plain PyTorch versions ``_fused_torch`` and
``_fused_zu_tail_torch``.  There is no fallback between the two: a CUDA
tensor never reaches a plain version, and a kernel that fails to build or
launch raises.
"""

from __future__ import annotations

import torch

from . import _cuda

# The kernel's launch plan: ZU_THREADS threads a block (csrc/zu_tail.cu
# kThreads), one 16-byte chunk of each vector per thread and loop trip, at
# most ZU_MAX_BLOCKS blocks (a grid-stride loop covers the rest).  The tail
# mode reduces its sums in one thread-block cluster when the grid has at
# most ZU_CLUSTER_BLOCKS blocks (kMaxCluster), else through a ticket.
ZU_THREADS = 256
ZU_MAX_BLOCKS = 1024
ZU_CLUSTER_BLOCKS = 8
ZU_SUMS = 5  # the tail's sums of squares, one partial each per block

# Flags of the tail mode (csrc/zu_tail.cu).
DOMAXITERS, NODUALERROR, NANGUARD = 1, 2, 4


def zu_blocks(n: int, itemsize: int) -> int:
    """Blocks of a launch over ``n`` elements of ``itemsize`` bytes: one
    16-byte chunk per thread, at least one block, at most ZU_MAX_BLOCKS."""
    per_block = ZU_THREADS * (16 // itemsize)
    return min(max(-(-n // per_block), 1), ZU_MAX_BLOCKS)


def zu_tail_plan(n: int, itemsize: int) -> tuple[int, bool]:
    """(blocks, cluster) of a tail-mode launch over ``n`` elements."""
    blocks = zu_blocks(n, itemsize)
    return blocks, blocks <= ZU_CLUSTER_BLOCKS


def zu_tail_scratch(n: int, dtype, device) -> torch.Tensor:
    """The tail mode's scratch for ``n`` elements: a zeroed ticket, then
    ZU_SUMS 8-byte partials per block.  Allocate it once per solve; every
    launch leaves the ticket at 0 again."""
    blocks = zu_blocks(n, torch.empty((), dtype=dtype).element_size())
    return torch.zeros(16 + 8 * ZU_SUMS * blocks, dtype=torch.uint8, device=device)


def _fused_torch(x, u, t):
    """Plain PyTorch version (mirrors ``admm_tpu.ops.kernels._fused_jnp``)."""
    v = x + u
    z = torch.sign(v) * torch.clamp_min(torch.abs(v) - t, 0.0)
    return z, u + x - z


def _check_vectors(what, dtype, device, **tensors):
    for name, a in tensors.items():
        if a.device != device or a.dtype != dtype:
            raise ValueError(f"{what}: {name} is {a.dtype} on {a.device}, "
                             f"expected {dtype} on {device}")


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
    _check_vectors("fused_soft_threshold_dual", x.dtype, x.device, u=u, t=t)
    if x.ndim != 1 or u.shape != x.shape:
        raise ValueError(
            f"fused_soft_threshold_dual: need 1-D x and u of one shape, got "
            f"{tuple(x.shape)} and {tuple(u.shape)}")
    x = x.contiguous()
    u = u.contiguous()
    z = torch.empty_like(x)
    unew = torch.empty_like(x)
    _cuda.zu(x, u, t, z, unew, zu_blocks(x.numel(), x.element_size()))
    fused_soft_threshold_dual.launches += 1
    return z, unew


def soft_threshold_pass(lam_of):
    """Mark a ``Hooks.fused_zu`` hook as the soft-threshold pass with
    t = lam / rho, ``lam_of(data)`` giving its lam (a 0-d tensor): the
    engine then runs the whole tail of the step through ``fused_zu_tail``."""

    def mark(hook):
        hook.soft_threshold_lam = lam_of
        return hook

    return mark


def _fro(v):
    """``engine._fro``: the squared sum's square root."""
    return torch.sqrt(torch.sum(v * v))


def _fused_zu_tail_torch(x_new, x, z, u, lam, rho, state, hist, *, perr_abs, derr_abs,
                         reltol, domaxiters, nodualerror, nanguard):
    """Plain version: the engine's generic tail (``engine._run``'s ``step``
    after ``prox_f``) for A = I, B = -I, c = 0 with ``_fused_torch``, op for
    op, so it equals that tail bit for bit.  There ``Ax + Bz - c`` is
    ``x_new + (-z') - 0``, which is ``x_new - z'``; ``rho A^T B (z' - z)``
    is ``-(rho (z' - z))``; ``max(., ||c||)`` with ``||c|| = 0`` leaves a
    norm (NaN included) as it is."""
    N = hist.shape[1] - 1
    k, done, diverged = state[0], state[1] != 0, state[2] != 0
    frozen = done | (k >= N)
    z_new, u_new = _fused_torch(x_new, u, lam / rho)
    pnorm = _fro(x_new - z_new)
    nan = torch.full((), float("nan"), dtype=hist.dtype, device=hist.device)
    dnorm = nan if nodualerror else _fro(rho * (z_new - z))
    perr = perr_abs + reltol * torch.maximum(_fro(x_new), _fro(z_new))
    derr = nan if nodualerror else derr_abs + reltol * _fro(rho * u_new)
    no = torch.zeros((), dtype=torch.bool, device=state.device)
    diverged_i = ~torch.isfinite(pnorm) if nanguard else no
    stop = no
    if not domaxiters:
        stop = pnorm < perr
        if not nodualerror:
            stop = stop & (dnorm < derr)
    slot = torch.where(frozen, N, k)
    hist[:4].index_copy_(1, slot.reshape(1),
                         torch.stack([pnorm, dnorm, perr, derr]).reshape(-1, 1))
    new_state = torch.stack((k + 1, (stop | diverged_i).long(), (diverged | diverged_i).long()))
    for old, new in ((x, x_new), (z, z_new), (u, u_new), (state, new_state)):
        old.copy_(torch.where(frozen, old, new))


def fused_zu_tail(x_new, x, z, u, lam, rho, state, hist, *, perr_abs, derr_abs, reltol,
                  domaxiters=False, nodualerror=False, nanguard=True, scratch=None):
    """One engine tail of the splitting A = I, B = -I, c = 0 with the
    soft-threshold z-prox (admm_tpu engine.py:606-711, 792-799), in place.

    ``x_new`` is ``prox_f``'s result; ``x``, ``z``, ``u`` the step's
    incoming iterates, all 1-D of one shape; ``lam`` and ``rho`` 0-d;
    ``state`` the int64 ``(k, done, diverged)``; ``hist`` ``(rows >= 4,
    N + 1)`` with rows pnorm, dnorm, perr, derr and the spare column N.
    ``perr_abs`` and ``derr_abs`` are sqrt(n) * abstol, ``reltol`` the
    relative tolerance (Python floats).  With ``frozen = done | k >= N``
    it writes the four norms into column ``N if frozen else k`` of
    ``hist`` and, unless frozen, sets x, z, u to x_new, z', u'' and
    advances ``state``.  On a CUDA device everything is contiguous, of one
    float dtype (f32 or f64), and ``scratch`` is ``zu_tail_scratch``'s
    (allocated here when None).
    """
    if x_new.ndim != 1 or not x.shape == z.shape == u.shape == x_new.shape:
        raise ValueError(
            f"fused_zu_tail: need 1-D x_new, x, z, u of one shape, got "
            f"{[tuple(a.shape) for a in (x_new, x, z, u)]}")
    if (lam.ndim, rho.ndim) != (0, 0) or state.shape != (3,) or state.dtype != torch.int64:
        raise ValueError("fused_zu_tail: need 0-d lam and rho and an int64 state of shape (3,)")
    if hist.ndim != 2 or hist.shape[0] < 4:
        raise ValueError(f"fused_zu_tail: need hist (rows >= 4, N + 1), got {tuple(hist.shape)}")
    if x.device.type == "cpu":
        _fused_zu_tail_torch(x_new, x, z, u, lam, rho, state, hist, perr_abs=perr_abs,
                             derr_abs=derr_abs, reltol=reltol, domaxiters=domaxiters,
                             nodualerror=nodualerror, nanguard=nanguard)
        return
    if x.device.type != "cuda":
        raise ValueError(f"fused_zu_tail: unsupported device {x.device}")
    if x.dtype not in (torch.float32, torch.float64):
        raise TypeError(f"fused_zu_tail: unsupported dtype {x.dtype}")
    _check_vectors("fused_zu_tail", x.dtype, x.device, x_new=x_new, z=z, u=u, lam=lam,
                   rho=rho, hist=hist)
    _check_vectors("fused_zu_tail", torch.int64, x.device, state=state)
    if not all(a.is_contiguous() for a in (x_new, x, z, u, state, hist)):
        raise ValueError("fused_zu_tail: the kernel needs contiguous tensors")
    if scratch is None:
        scratch = zu_tail_scratch(x.numel(), x.dtype, x.device)
    flags = ((DOMAXITERS if domaxiters else 0) | (NODUALERROR if nodualerror else 0)
             | (NANGUARD if nanguard else 0))
    _cuda.zu_tail(x_new, x, z, u, lam, rho, state, hist, perr_abs, derr_abs, reltol,
                  flags, scratch, *zu_tail_plan(x.numel(), x.element_size()))
    fused_zu_tail.launches += 1


# Launches of each kernel mode made by its wrapper in this process.
# Callers reset them to 0 and read them back to show that a run went
# through the kernel; the CPU path never counts.
fused_soft_threshold_dual.launches = 0
fused_zu_tail.launches = 0
