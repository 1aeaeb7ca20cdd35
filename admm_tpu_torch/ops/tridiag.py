"""Cyclic-reduction tridiagonal solver with precomputed elimination (port
of ``admm_tpu/ops/tridiag.py``: ``CyclicReductionSolver``).

The TV x-update solves the FIXED tridiagonal system (I + rho D^T D) x = b
every iteration (getProxOps.m:1044-1048).  The elimination coefficients
(alpha, beta, pivots) of every level are computed once at setup, in f64 on
the host, exactly as ``admm_tpu`` computes them; each ``solve(b)`` runs
only the b-phase over the system padded to N = 2^L - 1 with identity rows:

  forward, level l (stride s = 2^l):   active i (i mod 2s == 2s-1):
      b_i -= alpha^l_i b_{i-s} + beta^l_i b_{i+s}
  back substitution, level l = L-1..0: active i (i mod 2s == s-1):
      x_i = (b_i - a^l_i x_{i-s} - c^l_i x_{i+s}) / d^l_i

``cr_solve`` runs that b-phase on a ``(B, N)`` batch of padded right-hand
sides.  On a CPU tensor it runs the plain PyTorch version
``_cr_solve_torch``; on a CUDA tensor it launches the hand-written CUDA
C++ kernel of ``csrc/cr_solve.cu`` (built by ``ops/_cuda.py``) or raises.
The two round identically, so on the card they agree bit for bit.  The
kernel's tile plan (``tile_plan``) and compacted coefficient stacks
(``compact_stacks``) are built here, in Python, so the CPU tests reach
them.

``admm_tpu``'s ``PackedCyclicReductionSolver`` is not ported: it is the
reference's measured negative result (``admm_tpu/ops/tridiag.py:45-56``),
and the TV model refuses ``solver='cr_packed'``.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F

from . import _cuda

def _shift_up(v, s):
    """v_{i-s} along the last axis, with zeros shifted in."""
    return F.pad(v[..., : v.shape[-1] - s], (s, 0))


def _shift_down(v, s):
    """v_{i+s} along the last axis, with zeros shifted in."""
    return F.pad(v[..., s:], (0, s))


class CyclicReductionSolver:
    """Solve T x = b for a fixed tridiagonal T = tridiag(dl, d, du).

    ``dense_cutoff`` (``from_tridiag``) enables the HYBRID scheme of
    ``admm_tpu``: run only the first k masked levels and solve the level-k
    reduced system, of size 2^(L-k) - 1 <= dense_cutoff, with one
    precomputed dense inverse.

    The coefficient stacks live on the solve's device in the solve's
    dtype, cast once from the f64 precompute (f64 -> f32 rounds to
    nearest, as ``.astype`` does in ``admm_tpu``).
    """

    def __init__(self, alphas, betas, a_lv, c_lv, d_lv, masks_f, masks_b, n,
                 Tinv=None, cut_stride=1):
        self.alphas = alphas    # (k, N) forward elimination coefficients
        self.betas = betas      # (k, N)
        self.a_lv = a_lv        # (k, N) sub-diagonal entering each level
        self.c_lv = c_lv        # (k, N) super-diagonal entering each level
        self.d_lv = d_lv        # (k, N) pivots entering each level
        self.masks_f = masks_f  # (k, N) bool, forward-active rows
        self.masks_b = masks_b  # (k, N) bool, backsub-active rows
        self.n = n              # true (unpadded) size
        self.Tinv = Tinv        # (M, M) inverse of the level-k system, or None
        self.cut_stride = cut_stride  # 2^k; 1 = pure masked CR
        self._compact = None    # the kernel's stacks (compact_stacks)

    @classmethod
    def from_tridiag(cls, dl, d, du, dense_cutoff=None, *, device="cpu",
                     dtype=torch.float64) -> "CyclicReductionSolver":
        """Precompute the elimination state on the host (NumPy f64, as
        ``admm_tpu`` does) and store it on ``device`` in ``dtype``.

        ``dl[i] = T[i, i-1]`` (dl[0] unused), ``du[i] = T[i, i+1]``
        (du[-1] unused).  ``dense_cutoff``: stop the masked elimination
        once the reduced system is at most this size and finish it with a
        precomputed dense inverse.
        """
        dl = np.asarray(dl, np.float64)
        d0 = np.asarray(d, np.float64)
        du = np.asarray(du, np.float64)
        n = d0.shape[0]
        L = max(1, int(np.ceil(np.log2(n + 1))))
        N = 2**L - 1

        a = np.zeros(N)
        c = np.zeros(N)
        dd = np.ones(N)          # identity padding rows
        a[:n] = dl
        a[0] = 0.0
        c[:n] = du
        c[n - 1] = 0.0
        c[n:] = 0.0
        dd[:n] = d0

        # Hybrid cut: number of masked levels before the dense tail.
        n_levels = L
        if dense_cutoff is not None and dense_cutoff >= 1:
            k = 0
            while k < L - 1 and 2 ** (L - k) - 1 > dense_cutoff:
                k += 1
            n_levels = k

        alphas, betas = [], []
        a_lv, c_lv, d_lv = [], [], []
        masks_f, masks_b = [], []
        idx = np.arange(N)
        for l in range(n_levels):
            s = 2**l
            mf = (idx % (2 * s)) == (2 * s - 1)      # forward-active
            mb = (idx % (2 * s)) == (s - 1)          # backsub-active
            a_lv.append(a.copy())
            c_lv.append(c.copy())
            d_lv.append(dd.copy())
            masks_b.append(mb)

            am = np.roll(dd, s); am[:s] = 1.0        # d_{i-s}
            ap = np.roll(dd, -s); ap[-s:] = 1.0      # d_{i+s}
            alpha = np.where(mf, a / am, 0.0)
            beta = np.where(mf, c / ap, 0.0)
            alphas.append(alpha)
            betas.append(beta)
            masks_f.append(mf)

            a_up = np.roll(a, s); a_up[:s] = 0.0
            c_up = np.roll(c, s); c_up[:s] = 0.0
            a_dn = np.roll(a, -s); a_dn[-s:] = 0.0
            c_dn = np.roll(c, -s); c_dn[-s:] = 0.0
            dd = np.where(mf, dd - alpha * c_up - beta * a_dn, dd)
            a_new = np.where(mf, -alpha * a_up, a)
            c_new = np.where(mf, -beta * c_dn, c)
            a, c = a_new, c_new

        def put(arr, dt=dtype):
            return torch.tensor(arr, dtype=dt, device=device)

        Tinv, stride = None, 1
        if n_levels < L:
            # Dense inverse of the level-k reduced tridiagonal, which
            # lives on the stratum i = 2^k - 1 :: 2^k.
            stride = 2 ** n_levels
            sl = slice(stride - 1, None, stride)
            av, cv, dv = a[sl], c[sl], dd[sl]
            M = dv.shape[0]
            Tk = np.diag(dv)
            if M > 1:
                Tk += np.diag(av[1:], -1) + np.diag(cv[:-1], 1)
            Tinv = put(np.linalg.inv(Tk))

        def pack(arrs, dt=dtype):
            return put(np.stack(arrs) if arrs else np.zeros((0, N)), dt)

        return cls(
            pack(alphas), pack(betas), pack(a_lv), pack(c_lv), pack(d_lv),
            pack(masks_f, torch.bool), pack(masks_b, torch.bool), n,
            Tinv=Tinv, cut_stride=stride,
        )

    def solve(self, b, *, plain=False):
        """Solve T x = b for ``b`` of shape ``(..., n)``: the leading
        dimensions are a batch of right-hand sides (``admm_tpu``'s vmap).
        ``b`` must have the stacks' dtype and device.

        ``plain=True`` runs the b-phase through ``_cr_solve_torch`` on any
        device; it exists so that a GPU run can be compared with the
        kernel's (``chip_smoke.py``).  The solve path never takes it by
        itself.
        """
        n = self.n
        lead = b.shape[:-1]
        # .contiguous(): with nothing to pad, F.pad keeps a strided layout.
        bb = F.pad(b.reshape(-1, n), (0, self.alphas.shape[1] - n)).contiguous()
        x = (_cr_solve_torch if plain else cr_solve)(bb, self)
        return x[:, :n].reshape(lead + (n,))


def _tail(sol, y):
    """The hybrid tail: solve the level-k reduced systems of a contiguous
    ``(B, M)`` stratum ``y`` with the dense inverse.  Both paths of
    ``cr_solve`` make this same call on the same contiguous operand, so
    they round alike."""
    return torch.matmul(y, sol.Tinv.mT)


def _cr_solve_torch(bb, sol):
    """Plain PyTorch b-phase (mirrors ``admm_tpu``'s
    ``CyclicReductionSolver.solve``): ``(B, N)`` padded right-hand sides
    in, ``(B, N)`` solutions out.  ``bb`` is not modified."""
    k = sol.alphas.shape[0]  # masked levels (k under the hybrid cut)

    # forward b-reduction
    for l in range(k):
        s = 2**l
        upd = (
            bb
            - sol.alphas[l] * _shift_up(bb, s)
            - sol.betas[l] * _shift_down(bb, s)
        )
        bb = torch.where(sol.masks_f[l], upd, bb)

    x = torch.zeros_like(bb)
    if sol.Tinv is not None:
        # Dense tail: solve the level-k reduced system and scatter onto
        # its stratum.
        st = sol.cut_stride
        x[:, st - 1 :: st] = _tail(sol, bb[:, st - 1 :: st].contiguous())

    # back substitution
    for l in range(k - 1, -1, -1):
        s = 2**l
        num = (
            bb
            - sol.a_lv[l] * _shift_up(x, s)
            - sol.c_lv[l] * _shift_down(x, s)
        )
        x = torch.where(sol.masks_b[l], num / sol.d_lv[l], x)

    return x


def level_offsets(N, levels):
    """Where each level starts in the compacted stacks (the kernel computes
    the same sums itself): ``(f_off, b_off)``, each ``levels + 1`` ints.
    Forward level l has the ``(N+1) / 2^(l+1) - 1`` active rows
    ``i = (j+1) 2^(l+1) - 1``; back-substitution level l the
    ``(N+1) / 2^(l+1)`` rows ``i = j 2^(l+1) + 2^l - 1``."""
    f_off, b_off = [0], [0]
    for l in range(levels):
        f_off.append(f_off[-1] + ((N + 1) >> (l + 1)) - 1)
        b_off.append(b_off[-1] + ((N + 1) >> (l + 1)))
    return f_off, b_off


def compact_stacks(sol):
    """The kernel's coefficient stacks: only the active rows of each level,
    contiguous, level after level (``level_offsets``), as ``(alphas,
    betas, a_lv, c_lv, d_lv)``.  Built at the first kernel solve and kept
    on the solver; the plain version and the parity tests keep the full
    stacks."""
    if sol._compact is None:
        k = sol.alphas.shape[0]

        def pick(stack, forward):  # rows 2s-1 :: 2s forward, s-1 :: 2s back
            rows = [stack[l, (2 ** (l + 1) if forward else 2**l) - 1 :: 2 ** (l + 1)]
                    for l in range(k)]
            return torch.cat(rows) if rows else stack.new_zeros(0)

        sol._compact = (pick(sol.alphas, True), pick(sol.betas, True),
                        pick(sol.a_lv, False), pick(sol.c_lv, False), pick(sol.d_lv, False))
    return sol._compact


# The hybrid form's tiles: at least TILE_ROWS rows, and long enough that a
# launch has about TARGET_TILES tiles over all lanes: on an H100, 256-512
# tiles a launch did best at the TV shapes (experiments/cr_tile_sweep.py;
# PERF.md).  Shorter tiles redo more halo rows, more tiles take more waves.
TILE_ROWS = 512
TARGET_TILES = 512
SHARED_BYTES = 227 * 1024  # dynamic shared memory a block may use on Hopper


class TilePlan(NamedTuple):
    """How K4 cuts a ``(B, N)`` solve: ``tiles`` tiles per lane, tile t
    writing rows ``[t C, t C + C)`` and loading ``R`` more on each side
    (``rows = min(C + 2R, N)`` in all), with ``threads`` threads, its rows
    in shared memory when ``shared``."""
    C: int
    R: int
    tiles: int
    rows: int
    threads: int
    shared: bool


def tile_plan(N, levels, hybrid, itemsize, lanes=1):
    """K4's tile plan for ``lanes`` lanes of ``N`` rows.  The hybrid form
    (k = ``levels`` masked levels, then the dense tail) has radius
    ``R = 2^k - 1``: tiles of ``C`` rows as described at ``TILE_ROWS``, a
    multiple of 2^k, no longer than shared memory holds.  The pure masked
    form has the whole lane as radius: one tile of ``C = N`` rows,
    ``R = 0``."""
    if hybrid:
        st = 2**levels
        R = st - 1
        C = st * -(-max(TILE_ROWS, -(-lanes * N // TARGET_TILES)) // st)
        fit = (SHARED_BYTES // itemsize - 2 * R) // st * st
        if fit >= st:
            C = min(C, fit)
        threads = 256
    else:
        R, C, threads = 0, N, 1024
    rows = min(C + 2 * R, N)
    return TilePlan(C, R, -(-N // C), rows, threads, rows * itemsize <= SHARED_BYTES)


def cr_solve(bb, sol):
    """The b-phase of ``sol`` on a ``(B, N)`` batch of padded right-hand
    sides ``bb`` (N = 2^L - 1, the solver's padded size); returns a new
    ``(B, N)`` tensor of solutions and leaves ``bb`` as it was.

    ``bb`` must have the dtype and device of the solver's stacks.  On the
    CPU this is ``_cr_solve_torch``.  On a CUDA device it launches the
    kernel of ``csrc/cr_solve.cu`` (float32 or float64, contiguous
    ``bb``, at most 65535 lanes) on the tiles of ``tile_plan``: one launch
    for the pure masked form; for the hybrid form, a forward launch, the
    dense tail as one ``torch.matmul``, and a back-substitution launch.
    Anything the kernel does not take raises.
    """
    N = sol.alphas.shape[1]
    if bb.ndim != 2 or bb.shape[1] != N:
        raise ValueError(
            f"cr_solve: need a (B, {N}) batch of padded right-hand sides, "
            f"got shape {tuple(bb.shape)}")
    if bb.dtype != sol.alphas.dtype or bb.device != sol.alphas.device:
        raise ValueError(
            f"cr_solve: right-hand sides are {bb.dtype} on {bb.device}, the "
            f"solver's stacks {sol.alphas.dtype} on {sol.alphas.device}")
    if bb.device.type == "cpu":
        return _cr_solve_torch(bb, sol)
    if bb.device.type != "cuda":
        raise ValueError(f"cr_solve: unsupported device {bb.device}")
    if bb.dtype not in (torch.float32, torch.float64):
        raise TypeError(f"cr_solve: unsupported dtype {bb.dtype}")
    if not bb.is_contiguous():
        raise ValueError("cr_solve: the kernel needs contiguous right-hand sides")
    B, k = bb.shape[0], sol.alphas.shape[0]
    if B > 65535:
        raise ValueError(f"cr_solve: the kernel takes at most 65535 lanes, got {B}")

    stacks = compact_stacks(sol)
    hybrid = sol.Tinv is not None
    plan = tile_plan(N, k, hybrid, bb.element_size(), B)
    x = torch.empty_like(bb)
    if not hybrid:
        # Without shared memory the lane runs in its row of x.
        _cuda.cr_solve(bb, None, None, None, x, stacks, sol.n, k, plan,
                       None if plan.shared else x)
    else:
        scratch = None if plan.shared else bb.new_empty(B * plan.tiles * plan.rows)
        work = torch.empty_like(bb)
        y = bb.new_empty((B, sol.Tinv.shape[0]))
        _cuda.cr_solve(bb, work, None, y, None, stacks, sol.n, k, plan, scratch)
        _cuda.cr_solve(None, work, _tail(sol, y), None, x, stacks, sol.n, k, plan,
                       scratch)
    cr_solve.launches += 1
    return x


# Calls of ``cr_solve`` that launched the kernel in this process (one per
# solve, however many launches the hybrid form takes).  Callers reset it
# to 0 and read it back to show that a run went through the kernel; the
# CPU path never counts.
cr_solve.launches = 0
