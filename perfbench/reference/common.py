"""What the plain references share: the working precisions, the soft
threshold, the Boyd stop and the lanes' bookkeeping."""

from __future__ import annotations

import contextlib
import math

import torch

# The precision a reference computes in.  "tf32" is float32 whose matrix
# products round their operands to TF32 (10 mantissa bits) and accumulate
# in float32, as the card's TF32 mode does; it and "bfloat16" are the
# controls, the nearest precisions below what the configurations state.
DTYPES = {"float64": torch.float64, "tf32": torch.float32, "bfloat16": torch.bfloat16}


def round_tf32(t: torch.Tensor) -> torch.Tensor:
    """Round float32 values to the nearest TF32 value (13 low mantissa
    bits cleared, ties away from zero)."""
    bits = t.contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def matmul(precision: str):
    """``a @ b`` in ``precision``."""
    if precision == "tf32":
        return lambda a, b: round_tf32(a) @ round_tf32(b)
    return lambda a, b: a @ b


@contextlib.contextmanager
def full_precision_matmul():
    """float32 products at full precision (no TF32) inside the block."""
    cuda = torch.backends.cuda.matmul.allow_tf32
    cudnn = torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = cuda
        torch.backends.cudnn.allow_tf32 = cudnn


def soft_threshold(v, t):
    return torch.sign(v) * torch.clamp(torch.abs(v) - t, min=0.0)


def rownorm(v):
    return torch.linalg.vector_norm(v.float() if v.dtype == torch.bfloat16 else v, dim=-1)


class Lanes:
    """Per-lane step bookkeeping of a lanes ADMM loop.

    Each lane's own stop is the first step at which pnorm < perr and
    dnorm < derr (the cap ``maxiters`` where it never comes).  Each lane's
    iterate is kept at its target step: ``stop_at[b]`` where given, else
    its own stop."""

    def __init__(self, L, n_state, stop_at, maxiters, device, dtype):
        self.maxiters = maxiters
        self.own = torch.full((L,), -1, dtype=torch.int64, device=device)
        self.target = None if stop_at is None else torch.as_tensor(
            stop_at, dtype=torch.int64, device=device)
        self.taken = torch.zeros(L, dtype=torch.bool, device=device)
        self.keep = [torch.zeros((L, n), dtype=dtype, device=device) for n in n_state]

    def update(self, k, stop, state):
        """After step ``k`` (1-based) with this step's ``stop`` flags and
        iterates ``state``; returns whether every lane is finished
        (checked every 16 steps and at the cap, one host read each)."""
        newly = stop & (self.own < 0)
        self.own = torch.where(newly, torch.full_like(self.own, k), self.own)
        if self.target is None:
            take = newly | ((self.own < 0) & (k == self.maxiters))
        else:
            take = self.target == k
        take = take & ~self.taken
        for kept, v in zip(self.keep, state):
            kept.copy_(torch.where(take[:, None], v, kept))
        self.taken |= take
        if k == self.maxiters:
            self.own = torch.where(self.own < 0, torch.full_like(self.own, k), self.own)
            return True
        if k % 16 == 0:
            return bool((self.taken & (self.own >= 0)).all())
        return False

    def result(self):
        return (*self.keep, self.own.tolist())


def boyd_errors(n, abstol, reltol, primal_scale, dual_scale):
    """perr and derr of the Boyd stop: sqrt(n) abstol plus reltol times
    the larger primal norm, and times the dual norm."""
    return (math.sqrt(n) * abstol + reltol * primal_scale,
            math.sqrt(n) * abstol + reltol * dual_scale)
