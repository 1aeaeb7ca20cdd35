"""Triton kernel: fused soft-threshold + scaled-dual update for Hopper.

    v  = x + u
    z  = sign(v) * max(|v| - t, 0)
    u' = u + x - z

Replaces ``admm_tpu/ops/kernels.py::_fused_pallas`` (the Pallas TPU kernel
``_kernel`` launched over (rows, 128) tiles).

What bounds it: bytes.  Each element reads x and u and writes z and u'
(16 B per element at f32, 32 B at f64) for five flops, far below the
card's flop-per-byte balance, so the kernel can only be as fast as the
memory system.  The design does about that what a single pass can: one
1-D grid of BLOCK-element programs with a masked tail (no padding to a
tile shape and no slice-back copies), contiguous loads that Triton turns
into 16-byte vector accesses, and both updates fused so x and u are read
once.  The threshold ``t`` is read from a device pointer (a 0-d tensor
lam/rho), so the engine never waits on the host to pass it, and a later
CUDA-graph replay sees the current rho.  Outputs are out of place: the
engine's freeze mask needs the old u on frozen sub-steps.

At the headline size (n = 5000, 80 kB moved) one launch is bound by its
launch latency, not by bandwidth: it measured 1.4 us of device time per
call on an H100 80GB HBM3 at a 700 W power limit, where moving 80 kB at
the card's 3.35 TB/s takes under 0.03 us.  The plan for that is in ROADMAP.md:
K1b folds the engine tail's norms into this pass, and CUDA graphs take
the host out of the per-launch cost.

The arithmetic is written so that it rounds exactly as the plain version
``ops.kernels._fused_torch`` does: for v > t, sign(v)*(|v| - t) is v - t;
for v < -t it is -(-v - t), which equals v + t bit for bit; otherwise it
is sign(v)*0, which ``v * 0.0`` reproduces with its sign and with NaN
propagation.  No multiply feeds an add, so there is nothing for the
compiler to contract into an FMA.

Triton is imported when the kernel is first built, never when this module
is imported, so the module loads on hosts without Triton.
"""

from __future__ import annotations

import functools

BLOCK = 1024
NUM_WARPS = 4


@functools.cache
def _build():
    """Compile-on-first-use: import Triton and define the jitted kernel.
    ``tl`` is bound as a module global so the kernel body resolves it the
    way Triton expects of a module-level kernel."""
    global tl
    import triton
    import triton.language as tl

    @triton.jit
    def fused_zu_kernel(x_ptr, u_ptr, t_ptr, z_ptr, unew_ptr, n,
                        BLOCK: tl.constexpr):
        pid = tl.program_id(0)
        offs = pid * BLOCK + tl.arange(0, BLOCK)
        mask = offs < n
        x = tl.load(x_ptr + offs, mask=mask, other=0.0)
        u = tl.load(u_ptr + offs, mask=mask, other=0.0)
        t = tl.load(t_ptr)
        v = x + u
        z = tl.where(v > t, v - t, tl.where(v < -t, v + t, v * 0.0))
        tl.store(z_ptr + offs, z, mask=mask)
        tl.store(unew_ptr + offs, (u + x) - z, mask=mask)

    return triton, fused_zu_kernel


def launch(x, u, t, z, unew):
    """Launch the kernel on the current stream: ``z``/``unew`` are written.
    All five tensors are contiguous CUDA tensors of one float dtype; ``t``
    is 0-d.  The caller checks that."""
    triton, kernel = _build()
    n = x.numel()
    grid = (triton.cdiv(n, BLOCK),)
    kernel[grid](x, u, t, z, unew, n, BLOCK=BLOCK, num_warps=NUM_WARPS)
