"""Cyclic-reduction tridiagonal solver with precomputed elimination (port
of ``admm_tpu/ops/tridiag.py``: ``CyclicReductionSolver``).

The TV x-update solves the FIXED tridiagonal system (I + rho D^T D) x = b
every iteration (getProxOps.m:1044-1048).  The elimination coefficients
(alpha, beta, pivots) of every level are computed once at setup, in f64 on
the solve's device, with the bits of ``admm_tpu``'s NumPy precompute; each
``solve(b)`` runs only the b-phase over the system padded to N = 2^L - 1
with identity rows:

  forward, level l (stride s = 2^l):   active i (i mod 2s == 2s-1):
      b_i -= alpha^l_i b_{i-s} + beta^l_i b_{i+s}
  back substitution, level l = L-1..0: active i (i mod 2s == s-1):
      x_i = (b_i - a^l_i x_{i-s} - c^l_i x_{i+s}) / d^l_i

``cr_solve`` runs that b-phase on a ``(B, N)`` batch of padded right-hand
sides.  On a CPU tensor it runs the plain PyTorch version
``_cr_solve_torch``; on a CUDA tensor it launches the hand-written CUDA
C++ kernel of ``csrc/cr_solve.cu`` (built by ``ops/_cuda.py``) or raises.
The two round identically, so on the card they agree bit for bit.

On the card the solve is differentiable: x = T^-1 b is linear in b, so
its backward is the solve T^-T g (the solver of the transposed bands,
``transposed``; TV's system is symmetric and reuses its own) and its
forward-mode rule the solve T^-1 b', both kernel solves, and both fold
the lanes of ``torch.func.vmap`` into one kernel call
(``cr_solve_op``).  The coefficient stacks are constants: they get no
gradient.  The
kernel's tile plan (``tile_plan``) and compacted coefficient stacks
(``compact_stacks``) are built here, in Python, so the CPU tests reach
them.

``PackedCyclicReductionSolver`` (``admm_tpu``'s packed layout, TV's
``solver='cr_packed'``) keeps each level's coefficients packed to its
stratum; ``admm_tpu`` computes it in XLA ops, with no Pallas kernel, and
the port computes it in plain PyTorch ops on every device (it is
differentiable and vmappable as they are).
"""

from __future__ import annotations

import weakref
from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F

from . import _cuda

def _shift_up(v, s, fill=0.0):
    """v_{i-s} along the last axis, with ``fill`` shifted in."""
    return F.pad(v[..., : v.shape[-1] - s], (s, 0), value=fill)


def _shift_down(v, s, fill=0.0):
    """v_{i+s} along the last axis, with ``fill`` shifted in."""
    return F.pad(v[..., s:], (0, s), value=fill)


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

    # Calls of ``from_tridiag`` in this process whose recurrence ran on a
    # CUDA device (every call does the whole precompute: nothing is kept
    # across calls).  Callers reset it to 0 and read it back, as they do
    # ``cr_solve.launches``; a CPU build never counts.
    device_precomputes = 0

    def __init__(self, alphas, betas, a_lv, c_lv, d_lv, masks_f, masks_b, n,
                 Tinv=None, cut_stride=1, bands=None):
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
        self._bands = bands     # (dl, d, du, dense_cutoff) of from_tridiag
        self._transposed = None  # the solver of T^T (transposed)

    @classmethod
    def from_tridiag(cls, dl, d, du, dense_cutoff=None, *, device="cpu",
                     dtype=torch.float64) -> "CyclicReductionSolver":
        """Precompute the elimination state in f64 on ``device`` and store
        it there in ``dtype``.

        ``dl[i] = T[i, i-1]`` (dl[0] unused), ``du[i] = T[i, i+1]``
        (du[-1] unused).  ``dense_cutoff``: stop the masked elimination
        once the reduced system is at most this size and finish it with a
        precomputed dense inverse.

        The levels are ``admm_tpu``'s NumPy recurrence as separate torch
        ops in the same order (no fused multiply-add), so every device
        rounds them as NumPy does.  The dense inverse is NumPy's on the CPU,
        where the JAX package's bits are the reference, and
        ``torch.linalg.inv_ex`` elsewhere.  On a CUDA device nothing here
        waits for the device.
        """
        dl = np.asarray(dl, np.float64)
        d0 = np.asarray(d, np.float64)
        du = np.asarray(du, np.float64)
        device = torch.device(device)
        n = d0.shape[0]
        L = max(1, int(np.ceil(np.log2(n + 1))))
        N = 2**L - 1

        # The bands go up in one copy, from pinned memory on a CUDA device so
        # that the copy does not wait for the device, and are padded there:
        # identity rows, a[0] = 0, c[n-1:] = 0.
        bands = torch.from_numpy(np.stack((dl, d0, du)))
        if device.type == "cuda":
            bands = bands.pin_memory()
        bands = bands.to(device, non_blocking=True)
        a = F.pad(bands[0, 1:], (1, N - n))
        c = F.pad(bands[2, : n - 1], (0, N - n + 1))
        dd = F.pad(bands[1], (0, N - n), value=1.0)

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
        idx = torch.arange(N, device=device)
        for l in range(n_levels):
            s = 2**l
            mf = idx % (2 * s) == 2 * s - 1      # forward-active
            mb = idx % (2 * s) == s - 1          # backsub-active
            a_lv.append(a)
            c_lv.append(c)
            d_lv.append(dd)
            masks_b.append(mb)

            alpha = torch.where(mf, a / _shift_up(dd, s, 1.0), 0.0)
            beta = torch.where(mf, c / _shift_down(dd, s, 1.0), 0.0)
            alphas.append(alpha)
            betas.append(beta)
            masks_f.append(mf)

            dd = torch.where(mf, dd - alpha * _shift_up(c, s) - beta * _shift_down(a, s), dd)
            a, c = (torch.where(mf, -alpha * _shift_up(a, s), a),
                    torch.where(mf, -beta * _shift_down(c, s), c))

        Tinv, stride = None, 1
        if n_levels < L:
            # Dense inverse of the level-k reduced tridiagonal, which
            # lives on the stratum i = 2^k - 1 :: 2^k.
            stride = 2 ** n_levels
            av, cv, dv = (v[stride - 1 :: stride] for v in (a, c, dd))
            Tk = torch.diag(dv) + torch.diag(av[1:], -1) + torch.diag(cv[:-1], 1)
            if device.type == "cpu":
                Tinv = torch.from_numpy(np.linalg.inv(Tk.numpy()))
            else:
                Tinv = torch.linalg.inv_ex(Tk).inverse  # no error check, no wait
            Tinv = Tinv.to(dtype)

        def pack(arrs, dt=dtype):
            if not arrs:
                return torch.zeros((0, N), dtype=dt, device=device)
            return torch.stack(arrs).to(dt)

        sol = cls(
            pack(alphas), pack(betas), pack(a_lv), pack(c_lv), pack(d_lv),
            pack(masks_f, torch.bool), pack(masks_b, torch.bool), n,
            Tinv=Tinv, cut_stride=stride, bands=(dl, d0, du, dense_cutoff),
        )
        if device.type == "cuda":
            CyclicReductionSolver.device_precomputes += 1
            # The kernel's stacks now, with the set-up: built inside a captured
            # solve (graphs.py), they would be rebuilt at every replay.
            compact_stacks(sol)
        return sol

    def transposed(self) -> "CyclicReductionSolver":
        """The solver of T^T, for the solve's backward: this solver itself
        when the bands are each other's transpose (dl[1:] == du[:-1], as
        TV's are), else one built from the swapped bands at the first call
        and kept."""
        if self._transposed is None:
            if self._bands is None:
                raise ValueError("transposed: the solver was not built by from_tridiag")
            dl, d, du, cutoff = self._bands
            if np.array_equal(dl[1:], du[:-1]):
                self._transposed = self
            else:
                # T^T[i, i-1] = T[i-1, i] = du[i-1]; T^T[i, i+1] = T[i+1, i] = dl[i+1].
                self._transposed = CyclicReductionSolver.from_tridiag(
                    np.r_[0.0, du[:-1]], d, np.r_[dl[1:], 0.0], cutoff,
                    device=self.alphas.device, dtype=self.alphas.dtype)
        return self._transposed

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


class PackedCyclicReductionSolver:
    """Cyclic reduction with PACKED per-level state (port of
    ``admm_tpu/ops/tridiag.py:PackedCyclicReductionSolver``): each level's
    coefficients packed to its stratum, so level l moves 2^(L-l) values
    and a solve streams ~4 N values, where the masked form streams
    full-length arrays at every level.

    In packed coordinates p over the level-l system (size 2^(L-l) - 1,
    odd), the forward pass eliminates the odd positions (whose neighbours
    p +- 1 are even), the reduced system is the odd stratum, and back
    substitution solves the even positions from the known odd ones and
    interleaves them.  The b-phase is plain PyTorch: stride-2 slices, pads
    and one interleaving reshape per level.
    """

    def __init__(self, alphas, betas, a_lv, c_lv, d_lv, n):
        # Tuples of per-level packed tensors:
        #   alphas[l], betas[l]: (2^(L-l-1) - 1,) forward coefficients
        #   a_lv[l], c_lv[l], d_lv[l]: (2^(L-l-1),) back-substitution rows
        self.alphas = alphas
        self.betas = betas
        self.a_lv = a_lv
        self.c_lv = c_lv
        self.d_lv = d_lv
        self.n = n

    @classmethod
    def from_tridiag(cls, dl, d, du, *, device="cpu",
                     dtype=torch.float64) -> "PackedCyclicReductionSolver":
        """Precompute the packed elimination state on the host (NumPy f64,
        as ``admm_tpu`` does) and store it on ``device`` in ``dtype``;
        ``dl``/``du`` as in ``CyclicReductionSolver.from_tridiag``."""
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

        alphas, betas, a_lv, c_lv, d_lv = [], [], [], [], []
        for _ in range(L):
            odd_a, odd_c, odd_d = a[1::2], c[1::2], dd[1::2]
            ev_a, ev_c, ev_d = a[0::2], c[0::2], dd[0::2]
            m = odd_d.shape[0]           # 2^(L-l-1) - 1
            alpha = odd_a / ev_d[:m]     # / d_{p-1}
            beta = odd_c / ev_d[1:m + 1]  # / d_{p+1}
            alphas.append(alpha)
            betas.append(beta)
            a_lv.append(ev_a)
            c_lv.append(ev_c)
            d_lv.append(ev_d)
            # The reduced tridiagonal on the odd stratum.
            dd = odd_d - alpha * ev_c[:m] - beta * ev_a[1:m + 1]
            a = -alpha * ev_a[:m]
            c = -beta * ev_c[1:m + 1]

        # One host-to-device copy of every level's stacks, split into views.
        stacks = (alphas, betas, a_lv, c_lv, d_lv)
        sizes = [v.size for arrs in stacks for v in arrs]
        flat = torch.tensor(np.concatenate([v for arrs in stacks for v in arrs]), dtype=dtype,
                            device=device)
        views = iter(torch.split(flat, sizes))
        return cls(*(tuple(next(views) for _ in arrs) for arrs in stacks), n)

    def solve(self, b, *, plain=False):
        """Solve T x = b for ``b`` of shape ``(..., n)`` (leading batch
        dimensions allowed), in the stacks' dtype and on their device.
        ``plain`` is accepted for ``CyclicReductionSolver.solve``'s
        signature: this solve is plain PyTorch on every device."""
        del plain
        L = len(self.alphas)
        lead = b.shape[:-1]
        cur = F.pad(b, (0, 2**L - 1 - self.n))

        # Forward: eliminate the odd packed positions, recurse on them.
        evens = []
        for l in range(L):
            odd, ev = cur[..., 1::2], cur[..., 0::2]
            m = odd.shape[-1]
            evens.append(ev)
            cur = odd - self.alphas[l] * ev[..., :m] - self.betas[l] * ev[..., 1:m + 1]

        # Back substitution: solve the even positions, interleave.
        x = cur                  # the empty remnant below the last level
        for l in range(L - 1, -1, -1):
            m = x.shape[-1]      # the odd stratum's solutions
            x_even = (evens[l] - self.a_lv[l] * F.pad(x, (1, 0))
                      - self.c_lv[l] * F.pad(x, (0, 1))) / self.d_lv[l]
            merged = torch.stack((x_even[..., :m], x), dim=-1).reshape(lead + (2 * m,))
            x = torch.cat((merged, x_even[..., m:]), dim=-1)
        return x[..., :self.n]


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
    betas, a_lv, c_lv, d_lv)``.  Built once and kept on the solver
    (``from_tridiag`` builds them for a CUDA solver); the plain version and
    the parity tests keep the full stacks."""
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
    CPU this is ``_cr_solve_torch``.  On a CUDA device it runs the custom
    op ``admm_tpu_torch::cr_solve``, which launches the kernel of
    ``csrc/cr_solve.cu`` (float32 or float64, at most 65535 lanes) on the
    tiles of ``tile_plan``: one launch for the pure masked form; for the
    hybrid form, a forward launch, the dense tail as one
    ``torch.matmul``, and a back-substitution launch.  Under
    ``torch.func.vmap`` (the lanes of ``engine.make_admm_runner``) the op's
    vmap rule folds the lane axis into the kernel's own batch axis B, so
    the lanes' solves are one kernel solve.  Under autograd and
    ``torch.func`` it is differentiable in ``bb`` (``cr_solve_op``).
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
    return cr_solve_op(bb, sol)


def cr_solve_op(bb, sol):
    """The custom op ``admm_tpu_torch::cr_solve`` on ``(B, N)`` ``bb`` with
    its rules (``_CRSolve``): the backward T^-T g and the forward-mode
    rule T^-1 b' are solves of the same op, and under ``torch.func.vmap``
    the lanes fold into one call.  On a CUDA tensor every one of them is
    a kernel solve; on a CPU tensor the op runs the plain version, which
    is how the tests reach the rules.  ``cr_solve`` calls it for CUDA
    tensors."""
    _LIVE[id(sol)] = sol
    return _CRSolve.apply(bb, id(sol))


# The solvers the custom op can name, by ``id``: an op takes no Python
# object, so ``cr_solve`` hands it the solver's id and keeps the solver
# here for as long as something else holds it.
_LIVE = weakref.WeakValueDictionary()


@torch.library.custom_op("admm_tpu_torch::cr_solve", mutates_args=())
def _cr_solve_op(bb: torch.Tensor, solver: int) -> torch.Tensor:
    """``cr_solve`` on real ``(B, N)`` tensors: the kernel on a CUDA
    device, the plain version on the CPU (where only the tests call the op,
    to reach its vmap rule)."""
    sol = _LIVE[solver]
    if bb.device.type == "cpu":
        return _cr_solve_torch(bb, sol)
    return _cr_solve_kernel(bb, sol)


@_cr_solve_op.register_fake
def _(bb, solver):
    return torch.empty_like(bb)


def _cr_solve_lanes(info, in_dims, bb, solver):
    """The op's vmap rule: the lanes' ``(B, N)`` right-hand sides, whatever
    their lane axes, folded into the rows of one ``(lanes * B, N)`` call."""
    if in_dims[0] is None:
        return _cr_solve_op(bb, solver), None
    bb = bb.movedim(in_dims[0], 0)
    out = _cr_solve_op(bb.reshape(-1, bb.shape[-1]).contiguous(), solver)
    return out.reshape(bb.shape), 0


_cr_solve_op.register_vmap(_cr_solve_lanes)


class _CRSolve(torch.autograd.Function):
    """The op with its gradient rules.  x = T^-1 b is linear in b: the
    backward is ``cr_solve_op(g, sol.transposed())``, the forward-mode
    rule ``cr_solve_op(b', sol)``; both are again this Function, so they
    differentiate and batch like the forward.  ``vmap`` folds the lanes
    into the rows of one ``(lanes * B, N)`` call, as ``_cr_solve_lanes``
    does for the op alone, so a vmapped VJP or JVP is one solve too."""

    @staticmethod
    def forward(bb, solver):
        return _cr_solve_op(bb, solver)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.sol = _LIVE[inputs[1]]

    @staticmethod
    def backward(ctx, g):
        return cr_solve_op(g.contiguous(), ctx.sol.transposed()), None

    @staticmethod
    def jvp(ctx, bdot, _):
        return cr_solve_op(bdot.contiguous(), ctx.sol)

    @staticmethod
    def vmap(info, in_dims, bb, solver):
        if in_dims[0] is None:
            return _CRSolve.apply(bb, solver), None
        bb = bb.movedim(in_dims[0], 0)
        out = _CRSolve.apply(bb.reshape(-1, bb.shape[-1]).contiguous(), solver)
        return out.reshape(bb.shape), 0


def _cr_solve_kernel(bb, sol):
    """Launch K4 on the CUDA ``(B, N)`` ``bb``; counts one launch."""
    N = sol.alphas.shape[1]
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
# kernel solve, however many launches the hybrid form takes, and one for
# all the lanes of a vmapped solve).  Callers reset it to 0 and read it
# back to show that a run went through the kernel; the CPU path never
# counts.
cr_solve.launches = 0
