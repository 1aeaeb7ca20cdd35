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
``soft_threshold_pass``.  ``fused_diff_tail`` is the same tail for 1-D
TV's splitting A = D (``linop.DiffOp``), B = -I, c = 0, whose z-prox is
soft(u + D x, lam / rho); the engine takes it for a ``prox_g`` marked with
``soft_threshold_prox``.

On CUDA tensors they launch the hand-written CUDA C++ kernel of
``csrc/zu_tail.cu`` (z/u mode, tail mode and its difference-operator
mode; built by ``ops/_cuda.py``); on CPU tensors they run the plain
PyTorch versions ``_fused_torch`` and ``_fused_zu_tail_torch``.  There is
no fallback between the two: a CUDA tensor never reaches a plain version,
and a kernel that fails to build or launch raises.  The kernel has no
derivative rules: off the CPU, an operand that autograd or a
``torch.func`` transform follows raises ``NotImplementedError``
(``_cuda.refuse_autograd``).
"""

from __future__ import annotations

import torch

from ..linop import DiffOp
from . import _cuda
from .prox import soft_threshold

# The kernel's launch plan: ZU_THREADS threads a block (csrc/zu_tail.cu
# kThreads), one 16-byte chunk of each vector per thread and loop trip, at
# most ZU_MAX_BLOCKS blocks (a grid-stride loop covers the rest; in the
# difference-operator mode each block takes a contiguous run of whole
# tiles).  The tail mode reduces its sums in one thread-block cluster when
# the grid has at most ZU_CLUSTER_BLOCKS blocks (kMaxCluster), else through
# a ticket; the difference-operator mode always through the ticket, leaving
# ZU_EDGES values of its edge elements beside each block's partials.
ZU_THREADS = 256
ZU_MAX_BLOCKS = 1024
ZU_CLUSTER_BLOCKS = 8
ZU_SUMS = 5  # the tail's sums of squares, one partial each per block
ZU_EDGES = 4  # kEdges: e = z' - z and u'' of a block's first and last element

# Flags of the tail mode (csrc/zu_tail.cu); DIFFOP picks its
# difference-operator mode.
DOMAXITERS, NODUALERROR, NANGUARD, DIFFOP = 1, 2, 4, 8


def zu_blocks(n: int, itemsize: int) -> int:
    """Blocks of a launch over ``n`` elements of ``itemsize`` bytes: one
    16-byte chunk per thread, at least one block, at most ZU_MAX_BLOCKS."""
    per_block = ZU_THREADS * (16 // itemsize)
    return min(max(-(-n // per_block), 1), ZU_MAX_BLOCKS)


def zu_tail_plan(n: int, itemsize: int) -> tuple[int, bool]:
    """(blocks, cluster) of a tail-mode launch over ``n`` elements."""
    blocks = zu_blocks(n, itemsize)
    return blocks, blocks <= ZU_CLUSTER_BLOCKS


def zu_tail_scratch(n: int, dtype, device, diff: bool = False) -> torch.Tensor:
    """The tail mode's scratch for ``n`` elements: a zeroed ticket, then
    ZU_SUMS 8-byte partials per block (and ZU_EDGES more in the
    difference-operator mode, ``diff``).  Allocate it once per solve; every
    launch leaves the ticket at 0 again."""
    return torch.zeros(_scratch_bytes(n, dtype, diff), dtype=torch.uint8, device=device)


def _scratch_bytes(n, dtype, diff):
    blocks = zu_blocks(n, dtype.itemsize)
    return 16 + 8 * (ZU_SUMS + (ZU_EDGES if diff else 0)) * blocks


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
    _cuda.refuse_autograd("fused_soft_threshold_dual", x, u,
                          t if isinstance(t, torch.Tensor) else None)
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


def soft_threshold_prox(lam_of, op_of):
    """Mark a ``prox_g(x, z, u, rho, data)`` as soft(u + A x, lam / rho),
    ``lam_of(data)`` giving its lam (a 0-d tensor) and ``op_of(data)`` its
    operator A: when A is the engine's ``linop.DiffOp`` (1-D TV), the
    engine runs the whole tail of the step through ``fused_diff_tail``."""

    def mark(prox):
        prox.soft_threshold_lam = lam_of
        prox.soft_threshold_op = op_of
        return prox

    return mark


def _fro(v):
    """``engine.fro``: the squared sum's square root."""
    return torch.sqrt(torch.sum(v * v))


def _fused_zu_tail_torch(x_new, x, z, u, lam, rho, state, hist, *, perr_abs, derr_abs,
                         reltol, domaxiters, nodualerror, nanguard, op=None):
    """Plain version: the engine's generic tail (``engine._run``'s ``tail``
    and ``engine.run_steps``'s freeze select) for A = I, B = -I, c = 0 with
    ``_fused_torch``, or with ``op`` (a ``linop.DiffOp``) for A = op and
    the z-prox soft(u + A x, lam / rho), op for op, so it equals that tail
    bit for bit.  There ``Ax + Bz - c`` is ``Ax + (-z') - 0``, which is
    ``Ax - z'``; ``rho A^T B (z' - z)`` is ``-(rho A^T (z' - z))``, the
    same squares; ``max(., ||c||)`` with ``||c|| = 0`` leaves a norm (NaN
    included) as it is."""
    N = hist.shape[1] - 1
    k, done, diverged = state[0], state[1] != 0, state[2] != 0
    frozen = done | (k >= N)
    if op is None:
        Ax, At = x_new, (lambda v: v)
        z_new, u_new = _fused_torch(x_new, u, lam / rho)
        r = x_new - z_new
    else:
        Ax, At = op.mv(x_new), op.rmv
        z_new = soft_threshold(u + Ax, lam / rho)
        r = Ax - z_new
        u_new = u + r
    pnorm = _fro(r)
    nan = torch.full((), float("nan"), dtype=hist.dtype, device=hist.device)
    dnorm = nan if nodualerror else _fro(rho * At(z_new - z))
    perr = perr_abs + reltol * torch.maximum(_fro(Ax), _fro(z_new))
    derr = nan if nodualerror else derr_abs + reltol * _fro(rho * At(u_new))
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


def _tail(what, op, x_new, x, z, u, lam, rho, state, hist, perr_abs, derr_abs, reltol,
          domaxiters, nodualerror, nanguard, scratch):
    """``fused_zu_tail`` (``op`` None) and ``fused_diff_tail`` (``op`` the
    ``linop.DiffOp``): check the operands, then run the plain version on
    the CPU or launch the kernel's mode on a CUDA device.  Returns whether
    it launched."""
    if x_new.ndim != 1 or not x.shape == z.shape == u.shape == x_new.shape:
        raise ValueError(
            f"{what}: need 1-D x_new, x, z, u of one shape, got "
            f"{[tuple(a.shape) for a in (x_new, x, z, u)]}")
    if (lam.ndim, rho.ndim) != (0, 0) or state.shape != (3,) or state.dtype != torch.int64:
        raise ValueError(f"{what}: need 0-d lam and rho and an int64 state of shape (3,)")
    if hist.ndim != 2 or hist.shape[0] < 4:
        raise ValueError(f"{what}: need hist (rows >= 4, N + 1), got {tuple(hist.shape)}")
    if x.device.type == "cpu":
        _fused_zu_tail_torch(x_new, x, z, u, lam, rho, state, hist, perr_abs=perr_abs,
                             derr_abs=derr_abs, reltol=reltol, domaxiters=domaxiters,
                             nodualerror=nodualerror, nanguard=nanguard, op=op)
        return False
    _cuda.refuse_autograd(what, x_new, x, z, u, lam, rho)
    if x.device.type != "cuda":
        raise ValueError(f"{what}: unsupported device {x.device}")
    if x.dtype not in (torch.float32, torch.float64):
        raise TypeError(f"{what}: unsupported dtype {x.dtype}")
    _check_vectors(what, x.dtype, x.device, x_new=x_new, z=z, u=u, lam=lam, rho=rho,
                   hist=hist)
    _check_vectors(what, torch.int64, x.device, state=state)
    if not all(a.is_contiguous() for a in (x_new, x, z, u, state, hist)):
        raise ValueError(f"{what}: the kernel needs contiguous tensors")
    diff = op is not None
    need = _scratch_bytes(x.numel(), x.dtype, diff)
    if scratch is None:
        scratch = zu_tail_scratch(x.numel(), x.dtype, x.device, diff=diff)
    elif scratch.numel() < need or scratch.device != x.device:
        raise ValueError(f"{what}: scratch needs {need} bytes on {x.device}")
    flags = ((DOMAXITERS if domaxiters else 0) | (NODUALERROR if nodualerror else 0)
             | (NANGUARD if nanguard else 0) | (DIFFOP if diff else 0))
    _cuda.zu_tail(x_new, x, z, u, lam, rho, state, hist, perr_abs, derr_abs, reltol,
                  flags, scratch, *zu_tail_plan(x.numel(), x.element_size()))
    return True


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
    if _tail("fused_zu_tail", None, x_new, x, z, u, lam, rho, state, hist, perr_abs,
             derr_abs, reltol, domaxiters, nodualerror, nanguard, scratch):
        fused_zu_tail.launches += 1


def fused_diff_tail(x_new, x, z, u, lam, rho, state, hist, *, perr_abs, derr_abs, reltol,
                    domaxiters=False, nodualerror=False, nanguard=True, scratch=None):
    """``fused_zu_tail`` for 1-D TV's splitting A = D, B = -I, c = 0, with D
    the difference operator ``linop.DiffOp(n)`` and the z-prox
    z' = soft(u + D x_new, lam / rho): the residual is D x_new - z', the
    dual update u'' = u + (D x_new - z'), dnorm ||rho D^T (z' - z)||, perr
    takes max(||D x_new||, ||z'||) and derr ||rho D^T u''||.  The operands,
    options and effects are ``fused_zu_tail``'s; ``scratch`` is
    ``zu_tail_scratch(..., diff=True)``'s.
    """
    if _tail("fused_diff_tail", DiffOp(x_new.numel()), x_new, x, z, u, lam, rho, state, hist,
             perr_abs, derr_abs, reltol, domaxiters, nodualerror, nanguard, scratch):
        fused_diff_tail.launches += 1


# Launches of each kernel mode made by its wrapper in this process.
# Callers reset them to 0 and read them back to show that a run went
# through the kernel; the CPU path never counts.
fused_soft_threshold_dual.launches = 0
fused_zu_tail.launches = 0
fused_diff_tail.launches = 0
