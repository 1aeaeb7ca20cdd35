"""The chained GEMV pair (K2) and the resident fat-LASSO iteration (K3).

``gemv_pair(b, E, Dt, K)`` runs K steps of

    t = E b,   x = Dt t

with E ``(m, n)`` and Dt ``(n, m)`` in a stream dtype (float32 or
bfloat16), f32 accumulation, and b and t rounded to the stream dtype
before each product; the next step's b is the previous x.  It is the
counterpart of ``experiments/pallas_probe.py``'s kernel and, at K = 1
with bf16 streams, the x-update of ``FatShiftSolver.solve``
(``ops/solve.py``).

``resident_lasso(z, u, Dts, E, Dt, rho, kappa, K)`` runs K whole
fat-LASSO steps (``experiments/resident_iter_proto.py``'s kernel):

    b = Dts + rho (z - u);  x = b/rho - Dt (E b) / (rho rho)
    v = x + u;  z' = sign(v) max(|v| - kappa, 0);  u' = (u + x) - z'

updating z and u in place and returning the ``(K, 2)`` history
``(||x - z'||^2, rho^2 ||z' - z||^2)``.

On CPU tensors both run their plain PyTorch versions (``_gemv_pair_torch``,
``_resident_lasso_torch``).  On CUDA tensors they launch the hand-written
CUDA C++ kernels of ``csrc/gemv_pair.cu`` (built by ``ops/_cuda.py``) or
raise; there is no fallback.  Kernel and plain version agree to the f32
summation rounding of the dots, not bit for bit.

K2 is differentiable in b (``StreamPair``, an ``autograd.Function`` in the
``setup_context`` form).  x = Dt r(E r(b)), with r the rounding to the
stream dtype, is linear in b: the tangent is the same pair on b' (one K2
launch); the cotangent is the transposed pair r(E^T r(Dt^T g)) (one K2
launch on row-major copies of Dt^T and E^T, g read unrounded and the
result rounded: where JAX's transpose of ``FatShiftSolver.solve`` rounds).
E and Dt are constants: off the CPU a traced E or Dt raises
``NotImplementedError`` (``_cuda.refuse_autograd``), as does any traced
operand of K3, which has no derivative rules.
"""

from __future__ import annotations

import torch

from . import _cuda

STREAM_DTYPES = (torch.float32, torch.bfloat16)


def aligned_rows(A):
    """``A`` ``(rows, cols)`` as a row-major view whose rows start on
    16-byte boundaries (the kernels' vector loads): ``A`` itself if it is
    so already, else a copy into zeroed storage whose row stride is padded
    to a multiple of 16 bytes."""
    rows, cols = A.shape
    per = 16 // A.element_size()
    if (A.stride(1) == 1 and A.stride(0) % per == 0 and A.stride(0) >= cols
            and A.data_ptr() % 16 == 0):
        return A
    ld = -(-cols // per) * per
    out = A.new_zeros((rows, ld))[:, :cols]
    out.copy_(A)
    return out


def _gemv_pair_torch(b, E, Dt, K=1, exact=False):
    """Plain version: upcast the stream-typed operands to f32, multiply
    with ``torch.matmul``, round b (stream-typed or f32) and t with
    ``.to(stream dtype)``.  ``exact`` (the transposed pair of the
    backward): b is read as it is and x rounded to the stream dtype."""
    dt = E.dtype
    Ef, Dtf = E.float(), Dt.float()
    x = b
    for k in range(K):
        t = Ef @ (x.float() if exact and k == 0 else x.to(dt).float())
        x = Dtf @ t.to(dt).float()
    return x.to(dt).float() if exact else x


def _check_rows(name, A):
    rows, cols = A.shape  # a lone row or column may have any stride there
    if (cols > 1 and A.stride(1) != 1) or (rows > 1 and A.stride(0) < cols):
        raise ValueError(f"{name}: the kernel needs row-major rows (unit column "
                         f"stride), got strides {tuple(A.stride())}")


def _check_pair(b, E, Dt, K):
    if E.ndim != 2 or Dt.shape != E.shape[::-1] or b.shape != E.shape[1:]:
        raise ValueError(
            f"gemv_pair: need b (n,), E (m, n), Dt (n, m); got "
            f"{tuple(b.shape)}, {tuple(E.shape)}, {tuple(Dt.shape)}")
    if (E.dtype not in STREAM_DTYPES or Dt.dtype != E.dtype
            or b.dtype not in (E.dtype, torch.float32)):
        raise TypeError(
            f"gemv_pair: E, Dt must share a stream dtype of {STREAM_DTYPES} and b "
            f"be in it or in float32; got {b.dtype}, {E.dtype}, {Dt.dtype}")
    if not b.device == E.device == Dt.device:
        raise ValueError(f"gemv_pair: b, E, Dt on {b.device}, {E.device}, {Dt.device}")
    if not isinstance(K, int) or K < 1:
        raise ValueError(f"gemv_pair: K must be an int >= 1, got {K!r}")
    if min(E.shape) == 0:
        raise ValueError(f"gemv_pair: empty E {tuple(E.shape)}")


class StreamPair:
    """The operands of K2, ``E`` ``(m, n)`` and ``Dt`` ``(n, m)``, as a
    map ``x = pair(b, K)`` that autograd and ``torch.func`` differentiate
    in b.  ``exact`` marks the transposed pair of a backward (b read
    unrounded, x rounded to the stream dtype).  ``transposed()`` builds
    that pair once, from ``Dt_T`` (a row-major Dt^T the caller already
    holds, such as the solver's D) or a copy, and a row-major copy of E^T,
    and keeps it."""

    def __init__(self, E, Dt, exact=False, Dt_T=None):
        self.E, self.Dt, self.exact = E, Dt, exact
        self._Dt_T = Dt_T
        self._transposed = None

    def transposed(self):
        if self._transposed is None:
            Dt_T = aligned_rows(self.Dt.T if self._Dt_T is None else self._Dt_T)
            self._transposed = StreamPair(Dt_T, aligned_rows(self.E.T),
                                          exact=not self.exact, Dt_T=self.E)
            self._transposed._transposed = self
        return self._transposed

    def __call__(self, b, K=1):
        _check_pair(b, self.E, self.Dt, K)
        if _differentiated(self.E) or _differentiated(self.Dt):
            # The rules differentiate b alone.  On the CPU autograd follows
            # the plain version through every operand; off it, refuse.
            if b.device.type == "cpu":
                return _gemv_pair_torch(b, self.E, self.Dt, K, self.exact)
            _cuda.refuse_autograd("gemv_pair", self.E, self.Dt,
                                  missing="for E and Dt: K2's rules differentiate b alone")
        if _cuda._traced(b):
            return _PairFn.apply(b, self, K)
        return self.launch(b, K)

    def launch(self, b, K):
        """The pair on a checked b: the plain version on the CPU, else one
        launch of K2."""
        if self.exact:
            b = b.float()
        if b.device.type == "cpu":
            return _gemv_pair_torch(b, self.E, self.Dt, K, self.exact)
        if b.device.type != "cuda":
            raise ValueError(f"gemv_pair: unsupported device {b.device}")
        _check_rows("gemv_pair E", self.E)
        _check_rows("gemv_pair Dt", self.Dt)
        if not b.is_contiguous():
            raise ValueError("gemv_pair: the kernel needs a contiguous b")
        m, n = self.E.shape
        t = torch.empty(m, dtype=torch.float32, device=b.device)
        x = torch.empty(n, dtype=torch.float32, device=b.device)
        _cuda.gemv_pair(b, self.E, self.Dt, t, x, K, exact=self.exact)
        gemv_pair.launches += 1
        return x


def _differentiated(t):
    """Whether a gradient of ``t`` is asked for: it requires grad (at the
    innermost ``torch.func`` level too) with grad mode on, or carries a
    forward-mode tangent.  A tensor made inside a transform is wrapped by
    it without being differentiated."""
    return ((t.requires_grad and torch.is_grad_enabled())
            or torch.autograd.forward_ad.unpack_dual(t).tangent is not None)


class _PairFn(torch.autograd.Function):
    """``StreamPair`` with its rules.  The map is linear in b: the backward
    is the transposed pair on g, the forward-mode rule the same pair on
    b'; both are again this Function, so they differentiate and batch like
    the forward.  ``vmap`` keeps the lanes' route: lanes make the pair a
    GEMM, which K2, a one-lane GEMV kernel, does not run, so they take the
    plain version (the streams upcast to f32 for products with f32
    output, as ``admm_tpu``'s vmapped dots keep)."""

    @staticmethod
    def forward(b, pair, K):
        return pair.launch(b, K)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.pair, ctx.K, ctx.dtype = inputs[1], inputs[2], inputs[0].dtype

    @staticmethod
    def backward(ctx, g):
        return _PairFn.apply(g.contiguous(), ctx.pair.transposed(), ctx.K).to(ctx.dtype), None, None

    @staticmethod
    def jvp(ctx, bdot, _pair, _K):
        return _PairFn.apply(bdot.contiguous(), ctx.pair, ctx.K)

    @staticmethod
    def vmap(info, in_dims, b, pair, K):
        if in_dims[0] is None:
            return _PairFn.apply(b, pair, K), None
        lane = lambda v: _gemv_pair_torch(v, pair.E, pair.Dt, K, pair.exact)  # noqa: E731
        return torch.func.vmap(lane)(b.movedim(in_dims[0], 0)), 0


def gemv_pair(b, E, Dt, K=1):
    """K steps of ``x = Dt (E b)``; returns the f32 ``(n,)`` x of the last.

    ``E`` ``(m, n)`` and ``Dt`` ``(n, m)`` share one stream dtype (float32
    or bfloat16) and one device with ``b`` ``(n,)``, which is in the stream
    dtype or in float32 (then rounded to the stream dtype as it is read,
    the bits of ``b.to(stream dtype)``); ``K >= 1``.  On a CUDA device E
    and Dt need unit column stride (any row stride; rows on 16-byte
    boundaries, as ``aligned_rows`` makes them, take the vector loads) and
    b must be contiguous.  Differentiable in b (``StreamPair``; a backward
    copies Dt^T and E^T on every call, so a caller that differentiates
    often keeps a ``StreamPair``).
    """
    return StreamPair(E, Dt)(b, K)


def _resident_lasso_torch(z, u, Dts, E, Dt, rho, kappa, K):
    """Plain version: a Python loop of the same expressions, z and u
    updated in place."""
    hist = z.new_empty((K, 2))
    for k in range(K):
        b = Dts + rho * (z - u)
        t = E @ b
        x = b / rho - (Dt @ t) / (rho * rho)
        v = x + u
        z2 = torch.sign(v) * torch.clamp_min(torch.abs(v) - kappa, 0.0)
        u2 = (u + x) - z2
        hist[k, 0] = torch.sum((x - z2) ** 2)
        hist[k, 1] = (rho * rho) * torch.sum((z2 - z) ** 2)
        z.copy_(z2)
        u.copy_(u2)
    return hist


def resident_lasso(z, u, Dts, E, Dt, rho, kappa, K):
    """K whole fat-LASSO steps from ``(z, u)``, updated in place; returns
    the ``(K, 2)`` history ``(||x - z'||^2, rho^2 ||z' - z||^2)``.

    ``z``, ``u``, ``Dts`` ``(n,)``, ``E`` ``(m, n)`` and ``Dt`` ``(n, m)``
    share one float dtype and device; ``rho`` and ``kappa`` are Python
    floats; ``K >= 1``.  On a CUDA device everything is float32, z, u and
    Dts contiguous, and E and Dt have unit column stride.
    """
    if (E.ndim != 2 or Dt.shape != E.shape[::-1]
            or not z.shape == u.shape == Dts.shape == E.shape[1:]):
        raise ValueError(
            f"resident_lasso: need z, u, Dts (n,), E (m, n), Dt (n, m); got "
            f"{tuple(z.shape)}, {tuple(u.shape)}, {tuple(Dts.shape)}, "
            f"{tuple(E.shape)}, {tuple(Dt.shape)}")
    ops = (z, u, Dts, E, Dt)
    if not z.is_floating_point() or any(a.dtype != z.dtype for a in ops):
        raise TypeError(f"resident_lasso: operands must share one float dtype, "
                        f"got {[str(a.dtype) for a in ops]}")
    if any(a.device != z.device for a in ops):
        raise ValueError(f"resident_lasso: operands on {[str(a.device) for a in ops]}")
    if not isinstance(K, int) or K < 1:
        raise ValueError(f"resident_lasso: K must be an int >= 1, got {K!r}")
    if min(E.shape) == 0:
        raise ValueError(f"resident_lasso: empty E {tuple(E.shape)}")
    rho, kappa = float(rho), float(kappa)
    if z.device.type == "cpu":
        return _resident_lasso_torch(z, u, Dts, E, Dt, rho, kappa, K)
    _cuda.refuse_autograd("resident_lasso", z, u, Dts, E, Dt)
    if z.device.type != "cuda":
        raise ValueError(f"resident_lasso: unsupported device {z.device}")
    if z.dtype != torch.float32:
        raise TypeError(f"resident_lasso: the kernel takes float32, got {z.dtype}")
    _check_rows("resident_lasso E", E)
    _check_rows("resident_lasso Dt", Dt)
    if not (z.is_contiguous() and u.is_contiguous() and Dts.is_contiguous()):
        raise ValueError("resident_lasso: the kernel needs contiguous z, u and Dts")
    m, n = E.shape
    t = z.new_empty(m)
    partial = z.new_empty(2 * _cuda.resident_lasso_blocks(m, n))
    hist = z.new_empty((K, 2))
    _cuda.resident_lasso(z, u, Dts, E, Dt, t, partial, hist, rho, kappa, K)
    resident_lasso.launches += 1
    return hist


# Launches of each kernel made by its wrapper in this process.  Callers
# reset them to 0 and read them back to show that a run went through the
# kernel; the CPU path never counts.
gemv_pair.launches = 0
resident_lasso.launches = 0
