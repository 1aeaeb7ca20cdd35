"""Differentiable ADMM: implicit differentiation through the fixed point
(port of ``admm_tpu/diff.py``: the serial and the instance-batched
solvers).

The solution map ``data -> (x*, z*, u*)`` is differentiable by the
implicit function theorem at the ADMM fixed point

    w* = F(w*, data),      w = (x, z, u),

where ``F`` is ONE standard (alg 0) ADMM iteration in the engine's step
order (x-prox, optional relaxation, z-prox, dual update).  The solve is a
``torch.autograd.Function`` (``_Implicit``):

  * its forward runs the engine's runner (``make_admm_runner``) without
    gradients, so its outputs are ``admm``'s, bit for bit;
  * ``mode='vjp'`` gives it a backward: the adjoint fixed point
    wbar = cot + (dF/dw)^T wbar, with (dF/dw)^T one ``torch.func.vjp`` of F
    at w*, then one VJP of F with respect to the data;
  * ``mode='jvp'`` gives it a forward-mode rule: the tangent fixed point
    wdot = (dF/dw) wdot + (dF/ddata) data_dot, with dF/dw taken once at w*
    as the VJP of F's VJP (``_forward_map``: a forward-mode rule cannot
    nest forward AD, so ``torch.func.linearize`` cannot run there).

It takes the ``setup_context`` form, so ``loss.backward()``,
``torch.autograd.forward_ad``, ``torch.func.grad``, ``vjp``, ``jvp``,
``jacrev`` and ``jacfwd`` all run over it.  A solver used under the other
mode's transform raises a ``RuntimeError`` that names the mode to rebuild
with (``admm_tpu`` fails there with an opaque transpose error).  Gradients
flow to every floating tensor leaf of ``data`` (flattened with
``torch.utils._pytree``) and to ``c``; other leaves (operators, solver
objects, numbers) are constants, and so are the initial iterates.

The linear fixed point is solved by Neumann iteration, ``NEUMANN_CHUNK``
steps per host read with every step after the stop frozen on the device
(so the result equals a step-by-step loop bit for bit), or by restarted
GMRES of the port's own (``_gmres``; torch has none).  A solve is policed
with one host read: a diverged one (relative residual^2 above 1e10, or not
finite) is NaN-poisoned and named on stderr, an unconverged one warned
about.  Under ``torch.func.vmap`` of a backward or tangent (``jacrev``,
``jacfwd``) the cotangents become lanes of one solve, each lane frozen at
its own stop.  Under ``torch.func.vmap`` of a solve whose data, c or
iterates are batched (``vmap(loss)``, ``vmap(grad(loss))``) the batch
becomes lanes of one runner and its backward the lanes' adjoint
(``_Fold``); over a batch solver the outer batch folds into its lanes.

``make_implicit_batch_solver`` solves B instances as lanes of one runner
(``lanes=True``); its backward is the lanes' fixed point through one VJP
of the vmapped F, each lane frozen when its own Neumann test is met, as
``admm_tpu``'s batched ``while_loop`` selects finished lanes away.  On the
card, every kernel F reaches runs in the backward too: the TV x-prox's
cyclic-reduction solve (K4) has its own backward and forward-mode rules,
so an adjoint step of the lanes is one K4 solve.

``make_implicit_consensus_solver`` and ``make_implicit_unwrapped_solver``
differentiate the sharded runners of ``parallel/`` (consensus and
transpose reduction) the same way: the forward is the runner, F is its
standard step, and every sum over the shard axis in F goes through the
mesh (``parallel.mesh.Mesh``), so over a process group the adjoint's
Neumann steps cross the ranks as the forward's steps do (a sum over the
ranks is its own adjoint), and the linear solve's norms and inner
products add the ranks' parts of the sharded leaves.

Restrictions (checked at factory time, as in ``admm_tpu``): the standard
iteration (``fast=False``) and static rho; relaxation is supported.  Over
a process group both linear solves run: Neumann's and GMRES's sums add
the ranks' parts of the sharded leaves (``_sharded_reduce``).
"""

from __future__ import annotations

import copy
import functools
import sys
from typing import Callable, Optional

import numpy as np
import torch
from torch.utils import _pytree as pytree

from .config import ADMMConfig, matmul_precision, resolve_unroll
from .device import resolve_device
from .engine import Hooks, _run, make_admm_runner
from .linop import ScaledIdentityOp, as_linop

# Neumann steps per host read; the steps past the stop are frozen.
NEUMANN_CHUNK = 8
# jax.scipy.sparse.linalg.gmres's default restart length.
GMRES_RESTART = 20

# Relative residual^2 above which a backward solve is declared DIVERGED
# and NaN-poisoned (admm_tpu/diff.py:182: the Neumann blow-up exit fires
# at 1e12), and the softer bar of a loud-but-unpoisoned warning.
_DIVERGED_REL2 = 1e10
_UNCONVERGED_REL2 = 1e-8

def _sum2(t, lanes):
    """sum(t^2), per lane (leading axis) when ``lanes``."""
    sq = t * t
    return sq.reshape(sq.shape[0], -1).sum(1) if lanes else sq.sum()


def _lane(flag, t):
    """A flag, one per lane or 0-d, broadcast against ``t``."""
    return flag.reshape(flag.shape + (1,) * (t.ndim - flag.ndim))


def _neumann(apply_J, rhs, tol, maxiters, lanes, stats, reduce=None):
    """v = rhs + J v by the geometric series (``admm_tpu``'s recurrence,
    blow-up exit at 1e12 scale^2 and seed delta^2 = scale^2,
    admm_tpu/diff.py:137-161).  Steps run in chunks of NEUMANN_CHUNK with
    one host read after each; a step whose lane has stopped keeps its
    values.  ``reduce`` (a list of per-leaf sums of squares -> the same
    with the sharded leaves' summed over the ranks) makes the norms whole
    over a process group.  Returns (v, delta^2, scale^2, steps), the last
    three per lane or 0-d."""
    red = (lambda parts: parts) if reduce is None else reduce  # noqa: E731
    scale2 = sum(red([_sum2(r, lanes) for r in rhs])) + 1e-30
    # tol rounded to the solve's dtype, then squared, as admm_tpu does; a
    # fill, not a copy from the host, so the solve reads nothing back here.
    tol2 = torch.full_like(scale2, tol) ** 2 * scale2
    blow2 = 1e12 * scale2
    k = torch.zeros(scale2.shape, dtype=torch.int64, device=scale2.device)
    v, delta2 = rhs, scale2

    def running():
        return ((k < maxiters) & (delta2 > tol2) & torch.isfinite(delta2)
                & (delta2 <= blow2))

    while True:
        for _ in range(NEUMANN_CHUNK):
            live = running()
            new = tuple(r + j for r, j in zip(rhs, apply_J(v)))
            d2 = sum(red([_sum2(a - b, lanes) for a, b in zip(new, v)]))
            v = tuple(torch.where(_lane(live, a), a, b) for a, b in zip(new, v))
            delta2 = torch.where(live, d2, delta2)
            k = k + live.long()
            stats["applies"] += 1
        stats["reads"] += 1
        if not bool(running().any()):
            return v, delta2, scale2, k


def _gmres(apply_J, rhs, tol, maxiters, lanes, stats, reduce=None):
    """(I - J) v = rhs by restarted GMRES, one Krylov space per lane,
    following ``jax.scipy.sparse.linalg.gmres`` as admm_tpu calls it
    (admm_tpu/diff.py:165-172): restart GMRES_RESTART, x0 = rhs, stop at
    ||r|| <= tol ||rhs|| (atol 0), ``maxiters`` restart cycles, a full
    Arnoldi cycle with twice-run classical Gram-Schmidt and the small
    least-squares problem by its normal equations, and the true residual
    after every cycle.  One host read per cycle.  Returns (v, ||r||^2,
    scale^2, cycles).

    ``reduce`` (``_neumann``'s) makes every inner product whole over a
    process group: each sum adds the ranks' parts of the sharded leaves
    and counts the whole leaves once, one collective per Gram-Schmidt
    pass (its k inner products, and in the first pass the vector's norm,
    together).  H and the small solve are then the same bits on every
    rank, and so are the restart and stop decisions."""
    L = rhs[0].shape[0] if lanes else 1
    shapes = [tuple(r.shape[1:] if lanes else r.shape) for r in rhs]
    sizes = [int(np.prod(s)) for s in shapes]
    lead = (L,) if lanes else ()

    def pack(vs):
        return torch.cat([t.reshape(L, -1) for t in vs], dim=1)

    def unpack(X):
        return tuple(p.reshape(lead + s) for p, s in zip(torch.split(X, sizes, dim=1), shapes))

    def mv(X):
        return X - pack(apply_J(unpack(X)))

    def leaf_sums(X, Y):
        """Per leaf, the inner products of the rows of X (..., N) with Y (L, N)."""
        return [torch.einsum("l...n,ln->l...", a, b)
                for a, b in zip(torch.split(X, sizes, dim=-1), torch.split(Y, sizes, dim=-1))]

    def vnorm(X):
        if reduce is None:
            return torch.linalg.vector_norm(X, dim=-1)
        return torch.sqrt(sum(reduce(leaf_sums(X, X))))

    def gram_schmidt(V, w, first):
        """One pass's inner products of V's rows with w, and with
        ``first`` the norm of w."""
        if reduce is None:
            hj = torch.einsum("lkn,ln->lk", V, w)
            return hj, (torch.linalg.vector_norm(w, dim=-1) if first else None)
        if not first:
            return sum(reduce(leaf_sums(V, w))), None
        hs, ns = reduce(leaf_sums(V, w), leaf_sums(w, w))
        return sum(hs), torch.sqrt(sum(ns))

    def normalize(X, thresh):
        norm = vnorm(X)
        use = norm > thresh
        unit = X / torch.where(use, norm, 1.0)[:, None]
        return torch.where(use[:, None], unit, 0.0), torch.where(use, norm, 0.0)

    b = pack(rhs)
    eps = torch.finfo(b.dtype).eps
    m = GMRES_RESTART
    atol = tol * vnorm(b)
    x = b
    r = b - mv(x)
    unit, rnorm = normalize(r, eps)
    stats["applies"] += 1
    cycles = 0
    while cycles < maxiters:
        live = rnorm > atol
        stats["reads"] += 1
        if not bool(live.any()):
            break
        V = b.new_zeros((L, m + 1, b.shape[1]))
        V[:, 0] = unit
        H = torch.eye(m, m + 1, dtype=b.dtype, device=b.device).repeat(L, 1, 1)
        ok = torch.ones(L, dtype=torch.bool, device=b.device)
        for j in range(m):
            w = mv(V[:, j])
            h = torch.zeros_like(V[:, :, 0])
            for k in range(2):
                hj, w_norm = gram_schmidt(V, w, k == 0)
                if k == 0:
                    w0 = w_norm
                w = w - torch.einsum("lkn,lk->ln", V, hj)
                h = h + hj
            unit_v, norm_v = normalize(w, eps * w0)
            h[:, j + 1] = norm_v
            V[:, j + 1] = torch.where(ok[:, None], unit_v, V[:, j + 1])
            H[:, j] = torch.where(ok[:, None], h, H[:, j])
            ok = ok & (norm_v != 0)
        stats["applies"] += m
        beta = b.new_zeros((L, m + 1, 1))
        beta[:, 0, 0] = rnorm
        Ht = H.mT
        y = torch.linalg.solve_ex(Ht.mT @ Ht, Ht.mT @ beta)[0][..., 0]
        x = torch.where(live[:, None], x + torch.einsum("lkn,lk->ln", V[:, :m], y), x)
        r = b - mv(x)
        unit, rnorm = normalize(r, eps)
        stats["applies"] += 1
        cycles += 1
    if reduce is None:
        err2 = (r * r).sum(1)
        scale2 = sum(_sum2(t, lanes) for t in rhs) + 1e-30
    else:
        err2 = sum(reduce(leaf_sums(r, r)))
        scale2 = sum(reduce([_sum2(t, lanes) for t in rhs])) + 1e-30
    steps = torch.full_like(err2, cycles, dtype=torch.int64)
    return unpack(x), (err2 if lanes else err2[0]), scale2, (steps if lanes else steps[0])


def _police(v, err2, scale2, steps, what, stats):
    """NaN-poison a diverged solve and warn about an unconverged one
    (admm_tpu/diff.py:193-232), per lane; the relative residuals and
    steps come to the host in one read."""
    rel2 = err2 / scale2
    diverged = ~torch.isfinite(rel2) | (rel2 > _DIVERGED_REL2)
    host = torch.cat((rel2.reshape(-1).double(), steps.reshape(-1).double())).cpu().numpy()
    stats["reads"] += 1
    r, stats["steps"] = host[:rel2.numel()], host[rel2.numel():].astype(int).tolist()
    bad = ~np.isfinite(r) | (r > _DIVERGED_REL2)
    soft = ~bad & (r > _UNCONVERGED_REL2)
    worst = float(np.nanmax(np.where(np.isfinite(r), r, np.inf)))
    if bad.any():
        lanes = "" if r.size == 1 else f" ({int(bad.sum())}/{r.size} lanes)"
        print(f"admm_tpu_torch.diff: {what} linear solve DIVERGED{lanes}; "
              "affected gradients are NaN. The iteration map is not "
              "contractive at this fixed point (check rho / problem "
              "scaling), or try vjp_method='gmres' "
              f"(worst relative residual^2 {worst:.3e})", file=sys.stderr)
    elif soft.any():
        print(f"admm_tpu_torch.diff: {what} linear solve did not reach "
              "tolerance (raise vjp_maxiters or loosen vjp_tol); "
              "gradients may be inaccurate "
              f"(worst relative residual^2 {worst:.3e})", file=sys.stderr)
    return tuple(torch.where(_lane(diverged, t), torch.full_like(t, float("nan")), t)
                 for t in v)


def _forward_map(f, w):
    """v -> (df/dw) v at ``w``, by reverse over reverse: u -> (df/dw)^T u
    is linear, and its VJP is the JVP.  A forward-mode rule cannot nest
    forward AD (``torch.func.jvp`` and ``linearize`` refuse inside
    ``torch.autograd.forward_ad``), so the tangent solves take this form;
    each application is one backward of the VJP's graph."""
    out, pull = torch.func.vjp(f, w)
    _, push = torch.func.vjp(lambda u: pull(u)[0], tuple(torch.zeros_like(o) for o in out))
    return lambda v: push(v)[0]


class _Job:
    """One backward (``kind='adjoint'``) or tangent (``'tangent'``) linear
    solve of a problem: J built at w*, the fixed point solved, policed."""

    def __init__(self, problem, kind):
        self.problem = problem
        self.kind = kind

    def run(self, rhs, wstar, theta, shared):
        """Solve for the cotangents or tangents ``rhs``.  ``shared``: they
        carry a leading axis of lanes that share one J (``torch.func.vmap``
        over a serial backward or tangent)."""
        p = self.problem
        f = lambda w: p.one_iter(w, theta)  # noqa: E731
        with matmul_precision("highest"):
            if self.kind == "adjoint":
                _, pull = torch.func.vjp(f, tuple(wstar))
                apply_J = lambda v: pull(v)[0]  # noqa: E731
            else:
                apply_J = _forward_map(f, tuple(wstar))
            if shared:
                apply_J = torch.func.vmap(apply_J)
            stats = p.stats
            stats.update(applies=0, reads=0, steps=None)
            if p.method == "neumann":
                v, err2, scale2, steps = _neumann(apply_J, tuple(rhs), p.tol, p.maxiters,
                                                  p.lanes or shared, stats, p.reduce)
            else:
                v, err2, scale2, steps = _gmres(apply_J, tuple(rhs), p.tol, p.maxiters,
                                                p.lanes or shared, stats, p.reduce)
            what = f"engine {'adjoint (VJP)' if self.kind == 'adjoint' else 'tangent (JVP)'}"
            return _police(v, err2, scale2, steps, what, stats)


class _LinearFixedPoint(torch.autograd.Function):
    """A backward or tangent linear solve as a Function of its right-hand
    sides, so that its loop runs on plain tensors under every transform,
    and under ``torch.func.vmap`` (``jacrev``, ``jacfwd``) the vmapped
    right-hand sides become the lanes of one solve (``vmap``)."""

    @staticmethod
    def forward(job, n, *tensors):
        return job.run(tensors[:n], tensors[n:n + 3], tensors[n + 3:], shared=False)

    @staticmethod
    def setup_context(ctx, inputs, output):
        pass

    @staticmethod
    def backward(ctx, *grads):
        raise RuntimeError("admm_tpu_torch.diff: the backward of an implicit solve "
                           "is not differentiable again")

    @staticmethod
    def vmap(info, in_dims, job, n, *tensors):
        B, p = info.batch_size, job.problem
        rhs_dims, w_dims, theta_dims = in_dims[2:2 + n], in_dims[2 + n:5 + n], in_dims[5 + n:]
        rhs, wstar, theta = tensors[:n], tensors[n:n + 3], tensors[n + 3:]
        if not p.lanes and all(d is None for d in (*w_dims, *theta_dims)):
            # Only the right-hand sides are batched (jacrev, jacfwd): lanes
            # of one solve that share J.
            rhs = tuple(t.expand((B,) + tuple(t.shape)) if d is None else t.movedim(d, 0)
                        for t, d in zip(rhs, rhs_dims))
            out = job.run(rhs, wstar, theta, shared=True)
            return out, (0,) * len(out)
        # Batched iterates or data (vmap of a backward or tangent), or a
        # lanes problem: the outer batch folds into the problem's lanes.
        fold = _Fold(p, B, theta_dims)
        out = _Job(fold.problem, job.kind).run(
            tuple(fold.lane(t, d) for t, d in zip(rhs, rhs_dims)),
            tuple(fold.lane(t, d) for t, d in zip(wstar, w_dims)),
            fold.theta(theta), shared=False)
        return tuple(fold.unfold(t) for t in out), (0,) * len(out)


class _Fold:
    """``torch.func.vmap`` of batch size B over a solve (or one of its
    linear solves) as a lanes problem: the serial problem's solve becomes
    B lanes; a lanes problem's Bi lanes become B*Bi, outer batch major.
    ``theta_dims`` are the vmap dims of theta = (c, *leaves): a batched
    entry is mapped over the lanes, an unbatched one stays shared unless
    the inner lanes map it.  ``lane`` folds a per-lane tensor (iterates,
    right-hand sides), ``unfold`` restores the outer batch at dim 0."""

    def __init__(self, problem, B, theta_dims):
        self.B = B
        self.Bi = problem.batch if problem.lanes else None
        inner = ([problem.c_dim] + list(problem.leaf_dims) if problem.lanes
                 else [None] * len(theta_dims))
        self.inner = inner
        self.dims = theta_dims
        mapped = [None if (d is None and i is None) else 0 for d, i in zip(theta_dims, inner)]
        self.problem = problem.relaned(mapped[1:], mapped[0], B * (self.Bi or 1))

    def _fold(self, t, d, inner):
        B, Bi = self.B, self.Bi
        x = t.movedim(d, 0) if d is not None else t.expand((B,) + tuple(t.shape))
        if Bi is None:
            return x
        if inner is None:
            x = x.unsqueeze(1).expand((B, Bi) + tuple(x.shape[1:]))
        return x.reshape((B * Bi,) + tuple(x.shape[2:]))

    def theta(self, theta):
        return tuple(t if (d is None and i is None) else self._fold(t, d, i)
                     for t, d, i in zip(theta, self.dims, self.inner))

    def lane(self, t, d):
        return self._fold(t, d, 0).contiguous()

    def unfold(self, t):
        return t if self.Bi is None else t.reshape((self.B, self.Bi) + tuple(t.shape[1:]))


class _Problem:
    """What the Function of one solve call needs besides its tensors:
    the runner, the stationary map over the tensors of theta = (c, *data
    leaves), the mode and the linear solve's settings."""

    def __init__(self, runner, one_iter, rebuild, mode, method, tol, maxiters, stats,
                 lanes_runner, reduce=None):
        self.runner = runner
        self.reduce = reduce
        self._one_iter = one_iter
        self.rebuild = rebuild
        self.mode = mode
        self.method = method
        self.tol = tol
        self.maxiters = maxiters
        self.stats = stats
        self.lanes_runner = lanes_runner
        # One instance; ``relaned`` makes the lanes form.
        self.lanes, self.leaf_dims, self.c_dim, self.batch = False, None, None, None

    def relaned(self, leaf_dims, c_dim, batch):
        """This problem as ``batch`` lanes of one program: the leaves with
        dim 0 in ``leaf_dims`` (and c with ``c_dim`` 0) mapped over the
        lanes, the others shared; the runner is the engine's lanes runner
        (``lanes_runner``)."""
        out = copy.copy(self)
        out.lanes, out.leaf_dims, out.c_dim, out.batch = True, list(leaf_dims), c_dim, batch
        out.runner = self.lanes_runner(out.leaf_dims, c_dim)
        return out

    def forward(self, c, w0, leaves):
        raw = self.runner(*w0, c, self.rebuild(leaves))
        return raw["xopt"], raw["zopt"], raw["uopt"]

    def one_iter(self, w, theta):
        """F(w, theta) with theta = (c, *leaves); on lanes the vmapped map,
        lanes in w, in the mapped leaves and, with ``c_dim`` 0, in c."""
        if not self.lanes:
            return self._one_iter(tuple(w), theta[0], self.rebuild(theta[1:]))
        f = lambda w_, c_, ls: self._one_iter(w_, c_, self.rebuild(ls))  # noqa: E731
        return torch.func.vmap(f, in_dims=(0, self.c_dim, tuple(self.leaf_dims)))(
            tuple(w), theta[0], tuple(theta[1:]))

    def _sub(self, theta, idx):
        """F at w* as a function of the theta entries ``idx``."""
        def f(wstar, *sub):
            th = list(theta)
            for i, t in zip(idx, sub):
                th[i] = t
            return self.one_iter(wstar, th)
        return f

    def vjp(self, needs, theta, wstar, cots):
        cots = tuple(torch.zeros_like(w) if g is None else g for g, w in zip(cots, wstar))
        wbar = _LinearFixedPoint.apply(_Job(self, "adjoint"), 3, *cots, *wstar, *theta)
        idx = [i for i, need in enumerate(needs) if need]
        bars = [None] * len(theta)
        if idx:
            f = self._sub(theta, idx)
            with matmul_precision("highest"):
                _, pull = torch.func.vjp(lambda *sub: f(wstar, *sub), *(theta[i] for i in idx))
                for i, g in zip(idx, pull(wbar)):
                    bars[i] = g
        return bars

    def jvp(self, theta, wstar, tangents):
        idx = [i for i, t in enumerate(tangents) if t is not None]
        if not idx:
            return tuple(torch.zeros_like(w) for w in wstar)
        f = self._sub(theta, idx)
        with matmul_precision("highest"):
            push = _forward_map(lambda sub: f(wstar, *sub), tuple(theta[i] for i in idx))
            rhs = push(tuple(tangents[i] for i in idx))
        return _LinearFixedPoint.apply(_Job(self, "tangent"), 3, *rhs, *wstar, *theta)


def _wrong_mode(have, want):
    return RuntimeError(
        f"admm_tpu_torch.diff: this implicit solver was built with mode={have!r} "
        f"and cannot run under {'reverse' if want == 'vjp' else 'forward'}-mode "
        f"differentiation; rebuild it with mode={want!r}")


class _Implicit(torch.autograd.Function):
    """The solution map ``(c, x0, z0, u0, *leaves) -> (x*, z*, u*)`` of one
    solve call (its ``_Problem`` first)."""

    @staticmethod
    def forward(problem, c, x0, z0, u0, *leaves):
        return problem.forward(c, (x0, z0, u0), leaves)

    @staticmethod
    def setup_context(ctx, inputs, output):
        problem = inputs[0]
        ctx.problem = problem
        ctx.n_theta = 1 + len(inputs) - 5
        keep = (inputs[1], *inputs[5:], *output)
        if problem.mode == "vjp":
            ctx.save_for_backward(*keep)
        else:
            ctx.save_for_forward(*keep)

    @staticmethod
    def backward(ctx, gx, gz, gu):
        p = ctx.problem
        if p.mode != "vjp":
            raise _wrong_mode(p.mode, "vjp")
        saved = ctx.saved_tensors
        theta, wstar = saved[:ctx.n_theta], saved[ctx.n_theta:]
        needs = (ctx.needs_input_grad[1],) + tuple(ctx.needs_input_grad[5:])
        bars = p.vjp(needs, theta, wstar, (gx, gz, gu))
        return (None, bars[0], None, None, None, *bars[1:])

    @staticmethod
    def jvp(ctx, _problem, c_t, x0_t, z0_t, u0_t, *leaf_t):
        p = ctx.problem
        if p.mode != "jvp":
            raise _wrong_mode(p.mode, "jvp")
        saved = ctx.saved_tensors
        theta, wstar = saved[:ctx.n_theta], saved[ctx.n_theta:]
        return p.jvp(theta, wstar, (c_t, *leaf_t))

    @staticmethod
    def vmap(info, in_dims, problem, c, x0, z0, u0, *leaves):
        if all(d is None for d in in_dims[1:]):
            return _Implicit.apply(problem, c, x0, z0, u0, *leaves), (None, None, None)
        # Batched data or iterates: one lanes solve of the batch (folded
        # into the lanes of a batch problem), outputs batched at dim 0.
        dims = in_dims[1:]
        fold = _Fold(problem, info.batch_size, (dims[0],) + tuple(dims[4:]))
        theta = fold.theta((c,) + leaves)
        w0 = tuple(fold.lane(t, d) for t, d in zip((x0, z0, u0), dims[1:4]))
        out = _Implicit.apply(fold.problem, theta[0], *w0, *theta[1:])
        return tuple(fold.unfold(t) for t in out), (0, 0, 0)


def _check_diffable_config(config, mode, vjp_method):
    if config.alg != 0:
        raise ValueError(
            "implicit differentiation needs the standard iteration "
            "(fast=False, accelerated=False); the IFT is stated for a "
            "stationary map and the momentum state is not part of w")
    if config.dynamic_rho:
        raise ValueError("implicit differentiation needs static rho "
                         "(adaptive=False, rbadaptive=False)")
    if vjp_method not in ("neumann", "gmres"):
        raise ValueError(f"unknown vjp_method {vjp_method!r}")
    if mode not in ("vjp", "jvp"):
        raise ValueError(f"unknown mode {mode!r} (want 'vjp' or 'jvp')")


def _flatten(data):
    """(tensor leaves, rebuild): ``rebuild(tensors)`` is ``data`` with its
    tensor leaves replaced, in order, the other leaves kept (with
    ``keep=False`` replaced by None: ``rebuild(dims, keep=False)`` is the
    vmap ``in_dims`` of ``data``)."""
    flat, spec = pytree.tree_flatten(data)
    pos = [i for i, leaf in enumerate(flat) if isinstance(leaf, torch.Tensor)]

    def rebuild(tensors, keep=True):
        out = list(flat) if keep else [None] * len(flat)
        for i, t in zip(pos, tensors):
            out[i] = t
        return pytree.tree_unflatten(out, spec)

    return [flat[i] for i in pos], rebuild


class _Factory:
    """What ``make_implicit_solver`` and ``make_implicit_batch_solver``
    share: the config checks, the shapes, the runner and the map F."""

    def __init__(self, prox_f, prox_g, config, A, B, nA, nB, m, shape_x, shape_z, dtype,
                 mode, vjp_method, vjp_maxiters, vjp_tol, device, lanes=False, mapped=()):
        _check_diffable_config(config, mode, vjp_method)
        self.prox_f, self.prox_g, self.config = prox_f, prox_g, config
        self.A, self.B, self.m = A, B, m
        self.relax = float(config.relax)
        self.rho = float(config.rho)
        self.mode, self.method = mode, vjp_method
        self.maxiters, self.tol = int(vjp_maxiters), float(vjp_tol)
        self.dtype, self.device = dtype, device
        self.lanes, self.mapped = lanes, frozenset(mapped)
        # Shape resolution (admm_tpu/diff.py:366-382).
        A0, B0 = as_linop(A), as_linop(B)
        if nA is None and isinstance(A0, ScaledIdentityOp) and m is not None:
            nA = m
        if nB is None and isinstance(B0, ScaledIdentityOp) and m is not None:
            nB = m
        if shape_x is None:
            if nA is None:
                raise ValueError("provide nA, shape_x, or m")
            shape_x = (nA,)
        if shape_z is None:
            if nB is None:
                raise ValueError("provide nB, shape_z, or m")
            shape_z = (nB,)
        self.shape_x, self.shape_z = tuple(shape_x), tuple(shape_z)
        self.runner = make_admm_runner(prox_f, prox_g, config, A0, B0, hooks=Hooks(),
                                       has_data=True)
        self.stats = {"applies": 0, "reads": 0, "steps": None}

    def one_iter(self, A_op, B_op):
        """F(w, c, data): one standard ADMM iteration in the engine's step
        order (admm_tpu/diff.py:388-403), under the config's matmul
        precision."""
        prox_f, prox_g, relax, use_relax = self.prox_f, self.prox_g, self.relax, self.relax != 1.0
        rho, precision = self.rho, self.config.matmul_precision

        def F(w, c_arr, data):
            x, z, u = w
            with matmul_precision(precision):
                rho_ = torch.full((), rho, dtype=x.dtype, device=x.device)
                x1 = prox_f(x, z, u, rho_, data)
                if use_relax:
                    Axh = relax * A_op.mv(x1) - (1.0 - relax) * (B_op.mv(z) - c_arr)
                    z1 = prox_g(Axh, z, u, rho_, data)
                    u1 = u + (Axh + B_op.mv(z1) - c_arr)
                else:
                    z1 = prox_g(x1, z, u, rho_, data)
                    u1 = u + (A_op.mv(x1) + B_op.mv(z1) - c_arr)
            return (x1, z1, u1)

        return F

    def solve(self, data, c=0.0, x0=None, z0=None, u0=None):
        leaves, rebuild = _flatten(data)
        device = resolve_device(self.device, x0, z0, u0, c, *leaves)
        dt = self.dtype
        if dt is None:
            dt = next((torch.as_tensor(cand).dtype for cand in (x0, z0, u0)
                       if cand is not None and hasattr(cand, "dtype")), None)
        if dt is None:
            dt = next((t.dtype for t in leaves if t.is_floating_point()),
                      torch.get_default_dtype())
        A_op = as_linop(self.A, device=device, dtype=dt)
        B_op = as_linop(self.B, device=device, dtype=dt)
        c_arr = torch.as_tensor(c) if not isinstance(c, torch.Tensor) else c
        c_arr = c_arr.to(device=device, dtype=dt)
        if c_arr.ndim == 0:
            shape_c = A_op.out_shape(self.shape_x)
            if shape_c is None:
                if self.m is None:
                    raise ValueError("c is scalar and A is matrix-free: provide m")
                shape_c = (self.m,)
            c_arr = c_arr.expand(shape_c)
        c_arr = c_arr.contiguous()
        lead = ()
        leaf_dims = None
        if self.lanes:
            if not isinstance(data, dict):
                raise TypeError("make_implicit_batch_solver: data must be a dict")
            # Per leaf of data, in flattening order: whether its key is mapped.
            marks = pytree.tree_leaves({k: pytree.tree_map(lambda _, k=k: k in self.mapped, v)
                                        for k, v in data.items()})
            leaf_dims = [0 if mark else None
                         for mark, leaf in zip(marks, pytree.tree_leaves(data))
                         if isinstance(leaf, torch.Tensor)]
            sizes = {int(t.shape[0]) for t, d in zip(leaves, leaf_dims) if d == 0}
            if len(sizes) != 1:
                raise ValueError(f"make_implicit_batch_solver: the mapped leaves need one "
                                 f"leading lane axis, got sizes {sorted(sizes)}")
            lead = (sizes.pop(),)

        def init(v, shape):
            if v is None:
                return torch.zeros(lead + shape, dtype=dt, device=device)
            v = torch.as_tensor(v) if not isinstance(v, torch.Tensor) else v
            return v.to(device=device, dtype=dt)

        w0 = (init(x0, self.shape_x), init(z0, self.shape_z), init(u0, tuple(c_arr.shape)))
        problem = _Problem(self.runner, self.one_iter(A_op, B_op), rebuild, self.mode,
                           self.method, self.tol, self.maxiters, self.stats,
                           self.lanes_runner(A_op, B_op, rebuild))
        if self.lanes:
            problem = problem.relaned(leaf_dims, None, lead[0])
        return _Implicit.apply(problem, c_arr, *w0, *leaves)

    def lanes_runner(self, A_op, B_op, rebuild):
        """``(leaf_dims, c_dim) -> run``: the engine's lanes runner
        (``engine._run`` with ``data_dims``; ``make_admm_runner(lanes=True)``)
        over data whose leaves with dim 0 in ``leaf_dims`` carry the lanes;
        c is shared by the lanes unless ``c_dim`` is 0."""
        prox_f, prox_g = self.prox_f, self.prox_g
        config = resolve_unroll(self.config, "default")

        def make(leaf_dims, c_dim):
            dims = rebuild(leaf_dims, keep=False)

            def run(x0, z0, u0, c, data):
                if c_dim is None:
                    c = c.expand((x0.shape[0],) + tuple(c.shape))
                with matmul_precision(config.matmul_precision):
                    return _run(prox_f, prox_g, config, Hooks(), data, x0, z0, u0, c, A_op,
                                B_op, data_dims=dims)

            return run

        return make


def make_implicit_solver(
    prox_f: Callable,
    prox_g: Callable,
    config: ADMMConfig = ADMMConfig(),
    *,
    A=1.0,
    B=-1.0,
    nA: Optional[int] = None,
    nB: Optional[int] = None,
    m: Optional[int] = None,
    shape_x=None,
    shape_z=None,
    dtype=None,
    mode: str = "vjp",
    vjp_method: str = "neumann",
    vjp_maxiters: int = 500,
    vjp_tol: float = 1e-9,
    device=None,
):
    """Build a differentiable solution map ``solve(data, c=0.0) -> (x, z, u)``
    (``admm_tpu/diff.py:314-441``).

    ``prox_f(xhat, z, u, rho, data) -> x`` and ``prox_g(...) -> z`` follow
    the engine's data convention.  Gradients flow to every floating tensor
    leaf of ``data`` and to ``c``; ``A`` and ``B`` are constants (put
    constraint data that needs a gradient into ``data`` and use a
    matrix-free prox).

    ``mode``: ``'vjp'`` (default) for ``backward``, ``torch.func.grad``,
    ``vjp`` and ``jacrev``; ``'jvp'`` for ``torch.func.jvp``, ``jacfwd``
    and ``torch.autograd.forward_ad``.  ``vjp_method`` (``'neumann'`` or
    ``'gmres'``), ``vjp_tol`` and ``vjp_maxiters`` govern the linear solve
    in either mode (``vjp_maxiters`` counts GMRES's restart cycles).

    Returns ``solve(data, c=0.0, x0=None, z0=None, u0=None)``.  It runs on
    ``device``, or on the device of the first tensor among x0, z0, u0, c
    and ``data``'s leaves, or on the CUDA device (``device.resolve_device``);
    in ``dtype``, or x0's, z0's or u0's, or that of ``data``'s first
    floating leaf, or torch's default.  ``solve.stats`` holds the last
    backward or tangent solve's ``steps`` (per lane), J applications
    (``applies``) and host ``reads``.  Initial iterates get no gradient.
    ``torch.func.vmap`` over ``solve`` (batched data leaves, c or
    iterates) runs the batch as lanes of one runner, and under
    ``vmap(grad(...))`` its backward as the lanes' adjoint, each lane
    frozen at its own stop: what ``make_implicit_batch_solver`` runs.
    """
    fac = _Factory(prox_f, prox_g, config, A, B, nA, nB, m, shape_x, shape_z, dtype, mode,
                   vjp_method, vjp_maxiters, vjp_tol, device)

    def solve(data, c=0.0, x0=None, z0=None, u0=None):
        return fac.solve(data, c, x0, z0, u0)

    solve.stats = fac.stats
    return solve


def make_implicit_batch_solver(
    prox_f: Callable,
    prox_g: Callable,
    config: ADMMConfig = ADMMConfig(),
    *,
    mapped=(),
    mode: str = "vjp",
    vjp_method: str = "neumann",
    vjp_maxiters: int = 500,
    vjp_tol: float = 1e-9,
    **solver_kwargs,
):
    """Differentiable instance-batched solves (``admm_tpu/diff.py:637-678``):
    B problems against shared operators, each lane with its own adjoint or
    tangent solve.

    ``mapped`` names the keys of the dict ``data`` whose leaves carry a
    leading (B, ...) lane axis; the others are shared by every lane.  The
    forward is one lanes runner (``make_admm_runner(lanes=True)``); the
    backward is the lanes' fixed point through one VJP of the vmapped
    iteration map, each lane frozen at its own stop, so lane i's gradient
    is the serial solve's.  ``c`` is shared by the lanes.

    Returns ``solve(data, c=0.0, x0=None, z0=None, u0=None) -> (X, Z, U)``
    with (B, ...) outputs (x0, z0, u0, when given, carry the lane axis).
    The other keyword arguments (``A``, ``B``, ``nA``, ``nB``, ``m``,
    ``shape_x``, ``shape_z``, ``dtype``, ``device``) are
    ``make_implicit_solver``'s.
    """
    kw = {"A": 1.0, "B": -1.0, "nA": None, "nB": None, "m": None, "shape_x": None,
          "shape_z": None, "dtype": None, "device": None}
    unknown = set(solver_kwargs) - set(kw)
    if unknown:
        raise TypeError(f"make_implicit_batch_solver: unexpected arguments {sorted(unknown)}")
    kw.update(solver_kwargs)
    fac = _Factory(prox_f, prox_g, config, kw["A"], kw["B"], kw["nA"], kw["nB"], kw["m"],
                   kw["shape_x"], kw["shape_z"], kw["dtype"], mode, vjp_method,
                   vjp_maxiters, vjp_tol, kw["device"], lanes=True, mapped=mapped)

    def solve(data, c=0.0, x0=None, z0=None, u0=None):
        return fac.solve(data, c, x0, z0, u0)

    solve.stats = fac.stats
    return solve


def _sharded_reduce(mesh, sharded):
    """The linear solves' reduction over ``mesh``'s ranks for the leaves
    flagged in ``sharded``: ``reduce(parts, ...)`` takes lists of per-leaf
    partial sums and returns them with the sharded leaves' summed over
    the ranks, every list in one collective.  None on a stacked mesh
    (nothing to add)."""
    if mesh is None or mesh.group is None:
        return None
    idx = [i for i, flag in enumerate(sharded) if flag]

    def reduce(*lists):
        red = mesh.psum(*(parts[i] for parts in lists for i in idx))
        red = iter(red if isinstance(red, tuple) else (red,))
        out = []
        for parts in lists:
            parts = list(parts)
            for i in idx:
                parts[i] = next(red)
            out.append(parts)
        return out if len(lists) > 1 else out[0]

    return reduce


def _bcast_whole(mesh, tree, shards):
    """``tree`` with each tensor leaf that is not stacked over this rank's
    ``shards`` (a 0-d leaf, or one whose dim 0 differs) passed through
    ``mesh.bcast``: the data a shard computation reads whole."""
    if mesh.group is None:
        return tree
    return pytree.tree_map(
        lambda v: mesh.bcast(v) if isinstance(v, torch.Tensor) and (
            v.ndim == 0 or v.shape[0] != shards) else v, tree)


def _sharded_problem(runner, one_iter, data, mode, vjp_method, vjp_tol, vjp_maxiters, stats,
                     mesh, sharded, w0):
    """The solve call of a sharded implicit solver: ``_Implicit`` over a
    constant 0-d ``c`` (the sharded runners have no constraint offset)."""
    leaves, rebuild = _flatten(data)
    c = torch.zeros((), dtype=w0[0].dtype, device=w0[0].device)

    def lanes_runner(leaf_dims, c_dim):
        return functools.partial(runner, dims=rebuild(leaf_dims, keep=False))

    problem = _Problem(runner, lambda w, _c, d: one_iter(w, d), rebuild, mode, vjp_method,
                       vjp_tol, vjp_maxiters, stats, lanes_runner,
                       reduce=_sharded_reduce(mesh, sharded))
    return _Implicit.apply(problem, c, *w0, *leaves)


def _check_sharded(mesh, W):
    """The mesh of a sharded implicit solver (stacked when None), with the
    factory's check that its shards divide over the ranks."""
    if mesh is not None and mesh.group is not None and W % mesh.world:
        raise ValueError(f"W={W} shards do not divide over the {mesh.world} ranks of the "
                         f"mesh's process group")
    return mesh


def make_implicit_consensus_solver(
    local_prox: Callable,
    global_prox: Callable,
    config: ADMMConfig,
    n: int,
    W: int,
    *,
    mode: str = "vjp",
    vjp_method: str = "neumann",
    vjp_maxiters: int = 500,
    vjp_tol: float = 1e-9,
    mesh=None,
):
    """Differentiable consensus ADMM (``admm_tpu/diff.py:443-532``; the
    runner of ``parallel.consensus``).

    The fixed point lives on the sharded state ``w = (xi, z, ui)``, xi/ui
    of shape (W, n) and the global z of shape (n,); F is one consensus
    iteration (local solves, the shard-axis means, global prox, per-slice
    dual update; getProxOps.m:1217-1299).  The forward runs the consensus
    runner; the adjoint or tangent fixed point is solved as for
    ``make_implicit_solver``, with the means of F going through ``mesh``.

    ``local_prox(z, ui, rho, data) -> xi`` and ``global_prox(xbar, ubar,
    rho, W, data) -> z`` follow ``consensus_admm``'s contract.  Gradients
    flow to every floating tensor leaf of ``data``.

    ``mesh`` (default: stacked on the data's device) may place the shards
    over a process group (``parallel.global_mesh``): ``data``'s shard-axis
    leaves, ``xi0``/``ui0`` and the returned xi/ui are then this rank's
    block of W/P shards, as each process of ``admm_tpu`` holds its
    addressable shards of the global arrays.

    Returns ``solve(data, xi0=None, ui0=None, z0=None) -> (xi, z, ui)``
    (aggregate ``x* = xi.mean(0)`` over every shard as the consensus
    solution); ``solve.stats`` as in ``make_implicit_solver``.
    """
    from .parallel.consensus import _consensus_solve

    _check_diffable_config(config, mode, vjp_method)
    # unroll='auto': the factory cannot classify the user prox body.
    config = resolve_unroll(config, "default")
    mesh = _check_sharded(mesh, int(W))
    W, n = int(W), int(n)
    relax = float(config.relax)
    use_relax = relax != 1.0
    rho = float(config.rho)
    stats = {"applies": 0, "reads": 0, "steps": None}

    def runner(xi0, z0, ui0, _c, data, dims=None):
        out = _consensus_solve(local_prox, global_prox, config, W, n, data, xi0, ui0, z0,
                               data_dims=dims, mesh=run_mesh(xi0), local_state=True)
        return {"xopt": out["xi"], "zopt": out["zopt"], "uopt": out["ui"]}

    def run_mesh(t):
        if mesh is not None:
            return mesh
        from .parallel.mesh import Mesh

        return Mesh((W,), ("shards",), t.device)

    def one_iter(w, data):
        """One consensus iteration in the runner's alg-0 step order; over a
        process group the whole values (z, the data leaves without this
        rank's shard axis) enter the shard computations through
        ``Mesh.bcast``, so that their gradients count every rank once."""
        xi, z, ui = w
        on = run_mesh(xi)
        local = _bcast_whole(on, data, xi.shape[0])
        with matmul_precision(config.matmul_precision):
            rho_ = torch.full((), rho, dtype=xi.dtype, device=xi.device)
            zprev = z
            xi1 = local_prox(on.bcast(z), ui, rho_, local)
            xhat = (relax * xi1 + (1.0 - relax) * on.bcast(zprev)[None, :] if use_relax
                    else xi1)
            xbar, ubar = on.pmean(xi1, ui, grad=True)
            xhat_bar = relax * xbar + (1.0 - relax) * zprev if use_relax else xbar
            z1 = global_prox(xhat_bar, ubar, rho_, W, data)
            ui1 = ui + (xhat - on.bcast(z1)[None, :])
        return (xi1, z1, ui1)

    def solve(data, xi0=None, ui0=None, z0=None):
        leaves, _ = _flatten(data)
        dt = leaves[0].dtype if leaves else torch.get_default_dtype()
        device = mesh.device if mesh is not None else resolve_device(None, *leaves)
        Wl = W // (1 if mesh is None else mesh.world)

        def init(v, shape):
            if v is None:
                return torch.zeros(shape, dtype=dt, device=device)
            return torch.as_tensor(v).to(device=device, dtype=dt)

        w0 = (init(xi0, (Wl, n)), init(z0, (n,)), init(ui0, (Wl, n)))
        return _sharded_problem(runner, one_iter, data, mode, vjp_method, float(vjp_tol),
                                int(vjp_maxiters), stats, mesh, (True, False, True), w0)

    solve.stats = stats
    return solve


def make_implicit_unwrapped_solver(
    prox_g_shard: Callable,
    config: ADMMConfig,
    m: int,
    n: int,
    W: int,
    *,
    mode: str = "vjp",
    vjp_method: str = "neumann",
    vjp_maxiters: int = 500,
    vjp_tol: float = 1e-9,
    mesh=None,
):
    """Differentiable transpose-reduction (unwrapped) ADMM
    (``admm_tpu/diff.py:535-636``; the runner of
    ``parallel.transpose_reduction``).

    The fixed point is ``w = (x, zi, ui)``: the replicated primal x of
    shape (n,) and the row-sharded zi/ui of shape (W, m/W).  F is the
    runner's alg-0 step: per-shard ``Di^T (zi - ui)``, the sum over the
    shard axis (through ``mesh``), the replicated ``Winv`` solve, the
    per-shard z-prox and dual update.

    ``data`` keys: ``Di`` (W, m/W, n), ``Winv`` (n, n), ``mask`` (W, m/W)
    and optional ``aux`` (the prox's per-row operands).  Gradients flow to
    every floating tensor leaf.  Over a process group (``mesh``) the
    shard-axis leaves, zi0/ui0 and the returned zi/ui are this rank's
    block.  Polyhedral proxes (the SVM's hinge and 0-1 losses) put the
    optimum on their kinks, where the solution map is not differentiable;
    use a smooth per-shard prox for gradients (``admm_tpu``'s warning).

    Returns ``solve(data, x0=None, zi0=None, ui0=None) -> (x, zi, ui)``.
    """
    from .parallel.transpose_reduction import _unwrapped_solve

    _check_diffable_config(config, mode, vjp_method)
    config = resolve_unroll(config, "gemv")
    mesh = _check_sharded(mesh, int(W))
    m, n, W = int(m), int(n), int(W)
    relax = float(config.relax)
    use_relax = relax != 1.0
    rho = float(config.rho)
    stats = {"applies": 0, "reads": 0, "steps": None}

    def runner(x0, zi0, ui0, _c, data, dims=None):
        data = dict(data, aux=data.get("aux", ()))
        if dims is not None:
            dims = dict(dims, aux=dims.get("aux", ()))
        out = _unwrapped_solve(prox_g_shard, None, None, config, m, data, x0, zi0, ui0,
                               data_dims=dims, mesh=mesh, local_state=True)
        return {"xopt": out["xopt"], "zopt": out["zopt"], "uopt": out["uopt"]}

    def one_iter(w, data):
        """One transpose-reduction iteration in the runner's alg-0 order
        (whole values entering the shard computations through
        ``Mesh.bcast``, as in the consensus solver)."""
        x, zi, ui = w
        Di, Winv, mask = data["Di"], data["Winv"], data["mask"]
        aux = data.get("aux", ())
        psum = (lambda t: t) if mesh is None else functools.partial(mesh.psum, grad=True)
        bcast = (lambda t: t) if mesh is None else mesh.bcast  # noqa: E731
        if mesh is not None:
            aux = _bcast_whole(mesh, aux, zi.shape[0])
        with matmul_precision(config.matmul_precision):
            rho_ = torch.full((), rho, dtype=x.dtype, device=x.device)
            zprev = zi
            x1 = Winv @ psum(torch.einsum("wij,wi->j", Di, zi - ui))
            Dx = torch.einsum("wij,j->wi", Di, bcast(x1))
            Axr = relax * Dx + (1.0 - relax) * zprev if use_relax else Dx
            zi1 = prox_g_shard(Axr, zi, ui, rho_, aux) * mask
            ui1 = ui + (Axr - zi1) * mask
        return (x1, zi1, ui1)

    def solve(data, x0=None, zi0=None, ui0=None):
        Di = data["Di"]
        P = 1 if mesh is None else mesh.world
        if Di.ndim != 3 or Di.shape[0] * P != W or Di.shape[2] != n:
            raise ValueError(
                f"data['Di'] must have shape (W={W}, m/W, n={n}) (this rank's W/{P} shards "
                f"over a process group); got {tuple(Di.shape)}: the factory's W/n must match "
                f"the sharded row blocks")
        dt, device = Di.dtype, Di.device
        mi = Di.shape[1]

        def init(v, shape):
            if v is None:
                return torch.zeros(shape, dtype=dt, device=device)
            return torch.as_tensor(v).to(device=device, dtype=dt)

        w0 = (init(x0, (n,)), init(zi0, (Di.shape[0], mi)), init(ui0, (Di.shape[0], mi)))
        return _sharded_problem(runner, one_iter, data, mode, vjp_method, float(vjp_tol),
                                int(vjp_maxiters), stats, mesh, (False, True, True), w0)

    solve.stats = stats
    return solve
