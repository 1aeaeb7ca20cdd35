"""The core ADMM engine (port of ``admm_tpu/engine.py``).

``admm_tpu`` compiles the whole solve into one ``lax.while_loop`` whose
body runs K = ``config.unroll`` exact sub-steps.  Here the loop is a
Python loop over chunks of K sub-steps that run on the solve's device,
driven by ``run_steps`` for the generic step and for the consensus,
transpose-reduction and exchange runners of ``parallel/`` alike: a runner
hands it its x-update and its tail, and it owns the rest:

  * every sub-step computes ``frozen = done | (k >= N)`` on the device and
    selects the new state against it with ``torch.where``, and its
    history, iterate-record and Anderson-window writes go to a spare slot
    past the end when it is frozen, so results, step counts and histories
    equal K = 1 exactly (``admm_tpu``'s ``unrolled_body`` /
    ``freeze_helpers``, engine.py:392-445);
  * the host reads ``k`` and ``done`` once per chunk and nowhere else
    (with ``quiet=False`` the same read carries the chunk's table rows);
  * rho is a 0-d device tensor, changed on the device by the adaptive
    modes, so nothing in a chunk waits on the host.

The generic step runs every variant of ``admm_tpu``'s engine
(engine.py:575-880): fast (alg 1) and accelerated (alg 2) ADMM with
restart and d-values, the H-norm stop and ``convtest`` monitor, adaptive
and residual-balancing rho, the stall detector, Anderson acceleration
(``anderson.py``), the iterate records, relaxation, and the ``altu``,
``specialnorms``, ``preprocess``, ``obj`` and ``fused_zu`` hooks, and
``parallel=`` sliced proxes (``parallel/sliced.py``).

``make_admm_runner`` is the functional core; with ``lanes=True`` it
solves B independent instances as one program, the port's counterpart of
``jax.vmap`` over ``admm_tpu``'s runner: ``run_steps`` runs the generic
sub-step under ``torch.func.vmap`` with every buffer (history, iterate
records, Anderson rings) a step input written out of place, every
sub-step freezes the lanes that are done or at N steps, and the host
reads one flag a chunk, whether every lane is frozen.

When the ``fused_zu`` hook is the soft-threshold pass
(``ops/kernels.soft_threshold_pass``, lasso's ``use_fused_kernel``) and
the options ask for nothing beyond the standard stop, a step is ``prox_f``
plus one ``ops/kernels.fused_zu_tail``: the z/u pass, norms, Boyd errors,
flags, history write and freeze select in one launch of K1b on the card.
Likewise, when ``prox_g`` is marked as soft(u + A x, lam / rho)
(``ops/kernels.soft_threshold_prox``, 1-D TV's) with A the engine's
``linop.DiffOp``, B = -1, c = 0, one instance and nothing that autograd or
``torch.func`` follows, a step is ``prox_f`` plus one
``ops/kernels.fused_diff_tail``, K1b's difference-operator mode.
That path keeps k, done and diverged in one int64 device tensor,
freezes inside the kernel and updates its x, z and u in place: the engine
copies x0, z0 and u0 once at the start, so a caller's tensors are never
written.  It calls ``_run_chunks`` itself, without ``run_steps``.  Any
option the tail does not compute (``_tail_computes``) takes the generic
step, with the hook's z/u pass (K1's z/u mode) in place of ``prox_g``.

On a CUDA device a solve whose step runs only callables and operators
marked ``graphs.capture_safe`` (the package's LASSO and TV proxes), with
``quiet=True``, no Anderson window and nothing that autograd or
``torch.func`` follows, captures one sub-step as a CUDA graph and runs
each chunk as K replays of it (``graphs.py``): the step then works on
buffers the solve owns (``run_steps`` clones them; K1b's are its own),
and steps, histories and results are the eager chunk's.  Every other
solve runs its chunks eagerly.
"""

from __future__ import annotations

import math
import time
from typing import Any, Callable, NamedTuple, Optional

import numpy as np
import torch
from torch.utils import _pytree as pytree

from . import graphs
from .anderson import AndersonWindow
from .config import ADMMConfig, matmul_precision, resolve_unroll
from .device import resolve_device
from .linop import DiffOp, ScaledIdentityOp, as_linop
from .ops._cuda import _traced
from .ops.kernels import fused_diff_tail, fused_zu_tail, zu_tail_scratch
from .results import ADMMResults
from .utils.profiling import span


def fro2(v):
    """Squared Frobenius norm."""
    return torch.sum(v * v)


def fro(v):
    return torch.sqrt(fro2(v))


class Constraint(NamedTuple):
    """The constraint A x + B z = c (reference admm.m:79-245)."""

    A: Any  # LinOp
    B: Any  # LinOp
    c: Any  # tensor, same shape as A@x


class Hooks(NamedTuple):
    """Optional user hooks (reference admm.m:473-476, 553-560, 602-616).

    ``fused_zu(x, u, rho[, data]) -> (z, u)`` computes the z-prox AND the
    dual update in one pass for the A=1, B=-1, c=0 splitting (a GPU kernel
    in ``ops/kernels.py``).  Used only under alg 0 with relax == 1 and no
    altu; the engine takes prox_g + the standard dual update otherwise.
    """

    obj: Optional[Callable] = None          # obj(x, z) -> scalar
    altu: Optional[Callable] = None         # altu(u, Ax, Bz, c) -> u
    specialnorms: Optional[Callable] = None  # f(x,z,u,rho) -> (pnorm, dnorm)
    preprocess: Optional[Callable] = None   # run once host-side before solve
    fused_zu: Optional[Callable] = None     # (x, u, rho[, data]) -> (z, u)


def fast_update(alg: int, cfg: ADMMConfig, *, aprev, dprev, z, zprev, u,
                uprev, v, dval=None):
    """Shared Nesterov momentum / restart algebra (admm.m:563-600;
    ``admm_tpu`` engine.py:332-360), for the engine and the runners of
    later slices.

    ``z``/``u`` are the post-update iterates, ``zprev``/``uprev`` their
    values at iteration start, ``v`` the current z-predictor.  For
    alg == 2 the caller supplies ``dval``, the accelerated residual
    d = (1/rho)||u - uhat||^2 + rho||B(z - v)||^2.

    Returns ``(v_new, uhat_new, a_new, d_new, restarted_i)`` with
    ``d_new``/``restarted_i`` None unless alg == 2.
    """
    a_nr = 0.5 * (1.0 + torch.sqrt(1.0 + 4.0 * aprev**2))
    mom = (aprev - 1.0) / a_nr
    if alg == 1:
        return z + mom * (z - zprev), u + mom * (u - uprev), a_nr, None, None
    # alg == 2: restart rule d >= restart*dprev rolls the predictors back
    # (admm.m:570-599).
    no_restart = dval < cfg.restart * dprev
    v_new = torch.where(no_restart, z + mom * (z - zprev), zprev)
    uhat_new = torch.where(no_restart, u + mom * (u - uprev), uprev)
    a_new = torch.where(no_restart, a_nr, 1.0)
    d_new = torch.where(no_restart, dval, dprev / cfg.restart)
    restarted_i = torch.where(no_restart, 0, 1).to(torch.int32)
    return v_new, uhat_new, a_new, d_new, restarted_i


def adaptive_rho_update(cfg: ADMMConfig, *, Hprev, Hsq, rho, i, done, eps):
    """The reference's experimental adaptive-rho step (admm.m:724-741;
    ``admm_tpu`` engine.py:363-377): scalar wdiff = Hprev - Hsq with
    growth clamp 5, all on the device.  Faithful including its sign
    behaviour: if the H-norm rises within convtol, wdiff < 0 makes the
    step size negative there too; rbadaptive is the sign-safe scheme."""
    wdiff = Hprev - Hsq
    rhoprev = rho
    safe = torch.abs(wdiff) > eps
    rho_c = torch.where(safe, rho * rhoprev / torch.where(safe, wdiff, 1.0), rho)
    rhodiff = torch.abs(rho_c - rhoprev)
    growth = 5.0
    rho_c = torch.where(rhodiff >= rhoprev * growth, rho_c / growth, rho_c)
    rho_c = torch.where(rhodiff <= rhoprev / growth, rho_c * growth, rho_c)
    return torch.where((i > 2) & ~done, rho_c, rho)


def residual_balance_factor(cfg: ADMMConfig, *, pnorm, dnorm, done, dtype):
    """Residual-balancing rho factor (Boyd sec. 3.4.1; ``admm_tpu``
    engine.py:380-389): grow by rbtau when pnorm > rbmu*dnorm, shrink when
    dnorm > rbmu*pnorm, hold once done.  The caller applies rho *= factor
    and u /= factor (the scaled-dual rescale)."""
    grow = pnorm > cfg.rbmu * dnorm
    shrink = dnorm > cfg.rbmu * pnorm
    # Python floats rounded once to ``dtype``, as admm_tpu casts them, and
    # filled on pnorm's device (no copy from the host).
    tau, inv, one = (torch.full_like(pnorm, v, dtype=dtype)
                     for v in (cfg.rbtau, 1.0 / cfg.rbtau, 1.0))
    factor = torch.where(grow, tau, torch.where(shrink, inv, one))
    return torch.where(done, one, factor)


def sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def admm(
    prox_f: Callable,
    prox_g: Callable,
    config: ADMMConfig = ADMMConfig(),
    *,
    A=1.0,
    B=-1.0,
    c=0.0,
    m: Optional[int] = None,
    nA: Optional[int] = None,
    nB: Optional[int] = None,
    shape_x=None,
    shape_z=None,
    x0=None,
    z0=None,
    u0=None,
    hooks: Hooks = Hooks(),
    dtype=None,
    data=None,
    parallel: Optional[str] = None,
    slices=None,
    mesh=None,
    device=None,
) -> ADMMResults:
    """Solve min f(x) + g(z) s.t. A x + B z = c with scaled-dual ADMM.

    ``prox_f(xhat, z, u, rho) -> x`` and ``prox_g(xhat, z, u, rho) -> z``
    are the user proximal operators (reference admm.m:24-31).  Under
    relaxation (config.relax != 1) ``prox_g``'s first argument is the
    relaxed Axhat, exactly as in the reference (admm.m:515-532).  When
    ``data`` is given, every callable, the hooks included, takes it as an
    extra trailing argument, as in ``admm_tpu``.  ``A`` and ``B`` are
    scalars, matrices or operators (``linop.FnOp`` for callables; give
    ``m`` then, as its output shape is unknown).

    The solve runs on ``device``, or on the device of the first tensor
    among x0, z0, u0, c, A, B and ``data``'s values, or on the CUDA device
    (``device.resolve_device``: without one it raises).  The
    dtype is ``dtype``, or that of the first of x0, z0, u0, c that has
    one, or torch's default.

    ``parallel`` in {'xminf', 'zming', 'both'} mirrors the reference's
    options.parallel (admm.m:343-467): the corresponding prox argument is
    then a PER-SLICE prox ``prox_slice(x, z, u, rho, k)``, run for every
    slice of ``mesh`` (default ``parallel.make_mesh`` on the solve's
    device) and gathered into the full update (``parallel/sliced.py``);
    ``slices`` is a slicemaker spec (scalar block size, 0 for an even
    split, a vector of lengths, or a (slicesx, slicesz) pair for 'both').
    Sliced proxes do not take ``data`` and slice 1-D iterates only.
    """
    with span("admm_tpu_torch.prepare"):
        config = resolve_unroll(config, "default")
        device = resolve_device(device, x0, z0, u0, c, A, B, data)

        if dtype is None:
            dtype = next((_as_tensor(cand).dtype for cand in (x0, z0, u0, c)
                          if cand is not None and hasattr(cand, "dtype")),
                         torch.get_default_dtype())
        A = as_linop(A, device=device, dtype=dtype)
        B = as_linop(B, device=device, dtype=dtype)

        # --- shape/initial-state resolution (reference admm.m:79-259).
        if nA is None and isinstance(A, ScaledIdentityOp) and m is not None:
            nA = m
        if nB is None and isinstance(B, ScaledIdentityOp) and m is not None:
            nB = m
        if shape_x is None:
            if nA is None and x0 is None:
                raise ValueError("must provide nA, shape_x, or x0")
            shape_x = (nA,) if x0 is None else tuple(np.shape(x0))
        if shape_z is None:
            if nB is None and z0 is None:
                raise ValueError("must provide nB, shape_z, or z0")
            shape_z = (nB,) if z0 is None else tuple(np.shape(z0))

        def init(v, shape):
            if v is None:
                return torch.zeros(shape, dtype=dtype, device=device)
            return _as_tensor(v).to(device=device, dtype=dtype)

        x0 = init(x0, shape_x)
        z0 = init(z0, shape_z)
        # c: scalar 0 means zeros of the constraint-output shape (admm.m:99-110)
        c_arr = _as_tensor(c).to(device=device, dtype=dtype)
        if c_arr.ndim == 0:
            shape_c = A.out_shape(shape_x)
            if shape_c is None:
                if m is None:
                    raise ValueError("c is scalar and A is matrix-free: provide m")
                shape_c = (m,)
            c_arr = c_arr.expand(shape_c).contiguous()
        u0 = init(u0, tuple(c_arr.shape))

        if parallel is not None:
            # Engine-level sliced proxes (admm.m:343-467), sized from the
            # resolved iterate shapes.
            from .parallel.mesh import make_mesh
            from .parallel.sliced import make_parallel_proxes

            if data is not None:
                raise ValueError(
                    "parallel= sliced proxes do not take the data argument; close over "
                    "problem data in the per-slice prox instead")
            if len(shape_x) != 1 or len(shape_z) != 1:
                # The sliced gather reassembles a flat vector; the reference
                # slices vectors only (admm.m:343-467).
                raise ValueError(
                    "parallel= supports 1-D (vector) iterates only; got "
                    f"shape_x={tuple(shape_x)}, shape_z={tuple(shape_z)}")
            prox_f, prox_g = make_parallel_proxes(
                prox_f, prox_g, parallel, slices, nx=shape_x[0], nz=shape_z[0],
                mesh=make_mesh(device=device) if mesh is None else mesh)

        if hooks.fused_zu is not None:
            _check_fused_splitting(A, B, c_arr)

        if hooks.preprocess is not None:
            # Hooks follow the data convention (trailing data arg when given).
            hooks.preprocess(data) if data is not None else hooks.preprocess()

        sync(device)
    t0 = time.perf_counter()
    with matmul_precision(config.matmul_precision):
        raw = _run(prox_f, prox_g, config, hooks, data, x0, z0, u0, c_arr, A, B)
    sync(device)
    runtime = time.perf_counter() - t0
    with span("admm_tpu_torch.result"):
        res = ADMMResults.from_raw(raw, config, x0=x0, z0=z0, u0=u0)
    res.runtime = runtime
    if not config.quiet:
        # Final summary line (reference admm.m:759-765).
        print(f"ADMM finished: {res.steps} steps in {res.runtime:.4f}s"
              + (", DIVERGED" if res.diverged else ""))
    return res


def make_admm_runner(prox_f, prox_g, config: ADMMConfig, A, B, hooks: Hooks = Hooks(),
                     dtype=None, has_data: bool = False, *, lanes: bool = False,
                     mapped=()):
    """Functional core (``admm_tpu`` engine.py:460-481): returns
    ``run(x0, z0, u0, c) -> raw dict``, or ``run(x0, z0, u0, c, data)``
    with ``has_data``, holding ``admm``'s outputs as tensors (``steps``,
    ``xopt``, ``zopt``, ``uopt``, ``rho_final``, ``diverged``, ``stalled``,
    ``hist``, ``objopt``).  The solve runs on x0's device in x0's dtype,
    under ``config.matmul_precision``.  ``dtype`` is accepted for
    ``admm_tpu``'s signature and ignored, as there.

    ``lanes=True`` is the port's counterpart of ``jax.vmap`` over this
    runner: x0, z0, u0 and c carry a leading axis of B independent lanes,
    as do the keys of ``data`` named in ``mapped`` (the others are shared
    by every lane), and every output carries the lane axis.  The lanes run
    in one program (``run_steps``: ``torch.func.vmap`` over the sub-step),
    each with its own steps, stop flags, rho and histories; a lane that is done keeps
    its values while the others run on.  ``quiet=False`` prints the rows
    ``admm_tpu``'s vmapped table prints (``_run_chunks``).
    ``hooks.fused_zu`` does not run on lanes and raises
    ``NotImplementedError``.
    """
    del dtype
    config = resolve_unroll(config, "default")
    if lanes:
        mapped = frozenset(mapped)

    def run(x0, z0, u0, c, data=None):
        if not has_data and data is not None:
            raise TypeError("run() got data, but the runner was made with has_data=False")
        device, rdtype = x0.device, x0.dtype
        A_, B_ = (as_linop(op, device=device, dtype=rdtype) for op in (A, B))
        c_ = _as_tensor(c).to(device=device, dtype=rdtype)
        if c_.ndim == 0:
            c_ = c_.expand(u0.shape).contiguous()
        if hooks.fused_zu is not None:
            _check_fused_splitting(A_, B_, c_)
        dims = None
        if lanes:
            dims = {} if data is None else {k: (0 if k in mapped else None) for k in data}
        with matmul_precision(config.matmul_precision):
            return _run(prox_f, prox_g, config, hooks, data, x0, z0, u0, c_, A_, B_,
                        data_dims=dims)

    if has_data:
        return run
    return lambda x0, z0, u0, c: run(x0, z0, u0, c)


def _as_tensor(v):
    return v if isinstance(v, torch.Tensor) else torch.as_tensor(np.asarray(v))


def _is_scaled_identity(op, val):
    return isinstance(op, ScaledIdentityOp) and float(op.alpha) == val


def _check_fused_splitting(A, B, c):
    """hooks.fused_zu assumes the plain splitting A = I, B = -I, c = 0 —
    its dual update is u + x - z.  Any other A/B/c would make it silently
    wrong, so refuse up front."""
    if not (_is_scaled_identity(A, 1.0) and _is_scaled_identity(B, -1.0)):
        raise ValueError(
            "hooks.fused_zu requires the A=1, B=-1 splitting; got "
            f"A={A!r}, B={B!r} — use the standard prox_g path instead"
        )
    if bool(torch.any(c != 0)):
        raise ValueError(
            "hooks.fused_zu requires c = 0; got a nonzero c — use the "
            "standard prox_g path instead"
        )


def _tail_computes(cfg: ADMMConfig, hooks: Hooks) -> bool:
    """Whether K1b's tail (``fused_zu_tail``) computes everything the
    options ask of a step: the standard stop with fixed rho and nothing
    else.  It knows no rho update, u rescale, H-norm, stall window,
    Anderson window, iterate record or special norms; ``objevals`` and the
    ``quiet=False`` table read what it writes."""
    return not (cfg.adaptive or cfg.rbadaptive or cfg.needs_hnorm or cfg.stallwindow
                or cfg.anderson or cfg.record_iterates or hooks.specialnorms is not None)


def _bound(fn, d):
    """``fn`` with the solve's ``data`` bound as its trailing argument
    (None stays None)."""
    if fn is None or d is None:
        return fn
    return lambda *a: fn(*a, d)


def history(names, N, lead, dtype, device):
    """The scalar-trace buffer behind the ``lead`` (lane) axes: one row
    per name, N columns and the spare column N that frozen sub-steps write
    to."""
    return torch.full(tuple(lead) + (len(names), N + 1), float("nan"), dtype=dtype,
                      device=device)


def traces(names, bufs, N, lanes=False):
    """The ``hist`` dict of a result: each scalar trace and each other
    buffer but the Anderson rings, cut to N."""
    hist = bufs["hist"]
    out = {name: hist[..., i, :N] for i, name in enumerate(names)}
    out.update({name: buf[:, :N] if lanes else buf[:N] for name, buf in bufs.items()
                if name not in ("hist", "aF", "aT")})
    return out


def run_steps(xupdate, tail, state, bufs, data, N, K, *, data_dims=None, agree=None,
              table=False, kind=None):
    """Run a solve in chunks of K freeze-masked sub-steps until done or N
    steps (``_run_chunks``); returns the final ``(state, bufs)``.  The
    engine's generic step and the consensus, transpose-reduction and
    exchange runners all run here.

    ``state`` is a dict of tensors holding at least ``k`` (int64, the steps
    taken) and ``done``; ``bufs`` a dict of buffers (history and the like).
    A sub-step is ``x = xupdate(s, data)`` in the ``step.xupdate`` span,
    then in the ``step.tail`` span the freeze mask, ``tail(s, bufs, data,
    x, frozen, slot, put) -> (new, bufs)`` and the select.  ``new`` holds
    every key of ``s``.  ``tail`` writes a buffer with ``put(buf, dim,
    slot, rows)``: in place on one instance, out of place under vmap.
    With K > 1 or lanes, ``frozen = done | k >= N``: a frozen sub-step's
    ``slot`` (a 1-element int64 index) is the spare slot N past the end and
    ``torch.where(frozen, old, new)`` keeps its state, so results, steps
    and histories equal K = 1's (``admm_tpu``'s ``unrolled_body``).
    Otherwise ``frozen`` is None and ``slot`` is k: one instance at K = 1
    has the host check k and done before every sub-step.

    With ``data_dims`` (``data``'s in-dims: 0 for a leaf stacked over
    lanes, None for a shared one) the state and buffers carry a leading
    lane axis, the sub-step runs under ``torch.func.vmap`` and the lanes
    run until every one is frozen.  ``agree`` (lanes whose shards span
    ranks: ``Mesh.all_min``) takes the chunk's flags to their minimum over
    every rank, so that all ranks leave the loop after the same chunk.
    ``table`` prints ``quiet=False``'s table from the history's first four
    rows.  With ``kind`` (``graphs.ChunkGraph.kind``; never with
    ``table``) each chunk is K replays of a CUDA graph of one sub-step,
    which starts from clones of the state and buffers that the solve owns
    and ends by copying its result back into them."""
    lanes = data_dims is not None
    freeze = K > 1 or lanes
    # Under vmap the in-place index_copy_ has no batching rule and would run
    # lane by lane; the out-of-place form batches.
    put = torch.Tensor.index_copy if lanes else torch.Tensor.index_copy_
    device = state["k"].device
    spare = torch.tensor(N, dtype=torch.int64, device=device)

    def sub(s, b, d):
        with span("admm_tpu_torch.step.xupdate"):
            x = xupdate(s, d)
        with span("admm_tpu_torch.step.tail"):
            frozen = (s["done"] | (s["k"] >= N)) if freeze else None
            slot = (s["k"] if frozen is None else torch.where(frozen, spare, s["k"])).reshape(1)
            new, b = tail(s, dict(b), d, x, frozen, slot, put)
            if frozen is not None:
                new = {key: torch.where(frozen, old, new[key]) for key, old in s.items()}
        return new, b

    if lanes:
        run = torch.func.vmap(sub, in_dims=(0, 0, data_dims))

        def flags():
            s = cur[0]
            f = torch.stack((s["k"].min(), (s["done"] | (s["k"] >= N)).all().long()))
            return f if agree is None else agree(f)
    else:
        run = sub
        flags = lambda: torch.stack((cur[0]["k"], cur[0]["done"].long()))  # noqa: E731
    cur = [state, bufs]

    def one():
        cur[0], cur[1] = run(cur[0], cur[1], data)

    graph = None
    if kind is not None:
        cur[:] = owned = [{key: t.clone() for key, t in part.items()} for part in cur]

        def commit():
            # Each output is a new tensor or its own buffer (the in-place
            # writes of one instance).
            pairs = [(mine[key], t) for mine, part in zip(owned, cur)
                     for key, t in part.items() if t is not mine[key]]
            torch._foreach_copy_([b for b, _ in pairs], [t for _, t in pairs])
            cur[:] = owned

        graph = graphs.ChunkGraph(device, kind, commit)
    _run_chunks(one, flags, N, K, (lambda: cur[1]["hist"]) if table else None,
                lane_k=(lambda: cur[0]["k"]) if lanes and table else None, graph=graph)
    return cur


def _diff_tail_applies(prox_g, data, x0, z0, u0, c, A, B) -> bool:
    """Whether ``fused_diff_tail`` computes the z-update and dual update of
    a step that the generic tail would run with ``prox_g``: the prox is
    marked as soft(u + A x, lam / rho) with its operator a ``DiffOp`` of
    the engine's A, B = -1, x, z and u are 1-D f32 or f64 vectors, nothing
    that autograd or ``torch.func`` follows (the kernel has no derivative
    rules), and c = 0 (one read of the device at set-up, as
    ``_check_fused_splitting`` makes for K1b)."""
    op_of = getattr(prox_g, "soft_threshold_op", None)
    if op_of is None or type(A) is not DiffOp or not _is_scaled_identity(B, -1.0):
        return False
    op = op_of(data)
    if type(op) is not DiffOp or op.n != A.n or not x0.shape == z0.shape == u0.shape == (A.n,):
        return False
    if x0.dtype not in (torch.float32, torch.float64):
        return False
    if _followed(data, x0, z0, u0, c, A, B):
        return False
    return not bool(torch.any(c != 0))


def _run(prox_f, prox_g, cfg: ADMMConfig, hooks: Hooks, data,
         x0, z0, u0, c, A, B, data_dims=None) -> dict:
    """The loop (``admm_tpu`` engine.py:483-897).  Returns the raw result
    dict.

    With ``data_dims`` (a dict of ``data``'s keys: 0 for a leaf stacked
    over lanes, None for one the lanes share) the solve runs B independent
    lanes: x0, z0, u0 and c carry a leading lane axis, the step runs under
    ``torch.func.vmap``, every sub-step freezes the lanes that are done or
    at N steps, and the host reads one flag a chunk, whether all lanes are
    frozen (``admm_tpu``'s vmapped while_loop, engine.py:873-884).  Every
    result then carries the lane axis."""
    lanes = data_dims is not None
    if lanes:
        if hooks.fused_zu is not None:
            raise NotImplementedError(
                "admm_tpu_torch.engine: hooks.fused_zu launches K1 on one "
                "instance and does not run on lanes; pass Hooks(obj=...) only")
    lead = tuple(x0.shape[:1]) if lanes else ()
    alg = cfg.alg
    N = int(cfg.maxiters)
    K = int(cfg.unroll)
    relax = float(cfg.relax)
    use_relax = relax != 1.0
    needs_h = cfg.needs_hnorm
    std_stop = cfg.stopcond in ("standard", "both")
    h_stop = cfg.stopcond in ("hnorm", "both")
    use_stall = cfg.use_stall
    use_aa = cfg.anderson > 0
    record = cfg.record_iterates
    device, rdtype = x0.device, x0.dtype

    # Fused z+dual path applies only to the plain splitting (admm_tpu
    # engine.py:519-522).
    use_fused = hooks.fused_zu is not None and alg == 0 and not use_relax and hooks.altu is None
    record_obj = cfg.objevals and hooks.obj is not None

    rho0 = torch.tensor(cfg.rho, dtype=rdtype, device=device)
    eps = torch.finfo(rdtype).eps
    lane_fro = torch.func.vmap(fro) if lanes else fro
    cnorm = lane_fro(c)
    # Static element counts M1/M2 for Boyd errors (admm.m:644-645).
    perr_abs = math.sqrt(float(c[0].numel() if lanes else c.numel())) * cfg.abstol
    nan = torch.tensor(float("nan"), dtype=rdtype, device=device)
    no = torch.zeros((), dtype=torch.bool, device=device)
    scalar = lambda v: torch.as_tensor(v, dtype=rdtype, device=device)
    sizes = [sum(v[0].numel() if lanes else v.numel() for v in (x0, z0, u0))]

    # Scalar traces, one row each (``history``).  Traces of other shapes:
    # the int restart flags and the iterate records, leading axis N + 1
    # with the same spare slot.  Every buffer carries the lane axis first.
    names = (["pnorm", "dnorm", "perr", "derr"] + (["objvals"] if record_obj else [])
             + (["Hnormsq"] if needs_h else []) + (["dvals"] if alg == 2 else [])
             + (["avals"] if alg else []))
    bufs = {"hist": history(names, N, lead, rdtype, device)}
    if alg == 2:
        bufs["restarted"] = torch.zeros(lead + (N + 1,), dtype=torch.int32, device=device)
    if record:
        for name, like in (("xvals", x0), ("zvals", z0), ("uvals", u0)) + (
                (("vvals", z0), ("uhatvals", u0)) if alg else ()):
            bufs[name] = torch.zeros(lead + (N + 1,) + tuple(like.shape[len(lead):]),
                                     dtype=rdtype, device=device)
        bufs["wvals"] = torch.zeros(lead + (N + 1, sizes[0]), dtype=rdtype, device=device)
    window = AndersonWindow(cfg, sizes, dtype=rdtype, device=device) if use_aa else None
    if use_aa:
        bufs["aF"], bufs["aT"] = window.rings(lead)

    # The generic step, in ``run_steps``'s form: ``data`` there is
    # (c, cnorm, the solve's data), which the lanes carry too.
    def xupdate(s, d):
        """The x-update (admm.m:501-511)."""
        pf = _bound(prox_f, d[2])
        if alg == 0:
            return pf(s["x"], s["z"], s["u"], s["rho"])
        return pf(s["x"], s["v"], s["uhat"], s["rho"])

    def tail(s, bufs, d, x, frozen, slot, put):
        """The rest of a sub-step: the state and the buffers after it.
        Pure but for the buffers' writes (``put``)."""
        c, cnorm, d = d
        pg, obj_fn, altu_fn, norms_fn, fused_fn = (
            _bound(h, d) for h in (prox_g, hooks.obj, hooks.altu, hooks.specialnorms,
                                   hooks.fused_zu))
        k, rho = s["k"], s["rho"]
        # The reference's 1-based iteration counter, which only the H-norm
        # machinery (its stop, convtest, adaptive rho) and the d-value stop
        # read.
        i = k + 1 if needs_h or alg == 2 else None
        z, u = s["z"], s["u"]
        zprev = z
        if alg == 0:
            uhat = u
        else:
            uprev, uhat = u, s["uhat"]

        # ---- relaxation + z-update (admm.m:515-532) -------------------
        Ax_for_g = x
        Axhat = None
        if use_relax:
            Axhat = relax * A.mv(x) - (1.0 - relax) * (B.mv(zprev) - c)
            Ax_for_g = Axhat
        if use_fused:
            z, u_fused = fused_fn(x, u, rho)
        else:
            z = pg(Ax_for_g, z, u if alg == 0 else uhat, rho)

        Ax = A.mv(x)
        Bz = B.mv(z)
        Axr = Axhat if use_relax else Ax

        # ---- dual update (admm.m:538-560) -----------------------------
        if use_fused:
            u = u_fused
        elif altu_fn is not None:
            u = altu_fn(u, Axr, Bz, c)
        else:
            u = (u if alg == 0 else uhat) + (Axr + Bz - c)

        # ---- fast / accelerated updates (admm.m:563-600) --------------
        v_new, uhat_new, a_new, d_new = (s.get(key) for key in ("v", "uhat", "a", "d"))
        restarted_i = None
        if alg:
            dval = ((1.0 / rho) * fro2(u - uhat) + rho * fro2(B.mv(z - s["v"]))
                    if alg == 2 else None)
            v_new, uhat_new, a_new, d2, r2 = fast_update(
                alg, cfg, aprev=s["a"], dprev=s.get("d"), z=z, zprev=zprev, u=u, uprev=uprev,
                v=s["v"], dval=dval)
            if alg == 2:
                d_new, restarted_i = d2, r2

        # ---- norms (admm.m:612-637) -----------------------------------
        if norms_fn is not None:
            pnorm, dnorm = (scalar(v) for v in norms_fn(x, z, u, rho))
        else:
            pnorm = fro(Ax + Bz - c)
            if cfg.nodualerror:
                dnorm = nan
            elif alg == 1:
                dnorm = rho * fro(A.rmv(B.mv(z - v_new)))
            else:  # alg 0 (and alg 2, recorded for observability)
                dnorm = fro(rho * A.rmv(B.mv(z - zprev)))

        # ---- Boyd errors (admm.m:639-658) -----------------------------
        M2 = float(Bz.numel())
        perr = perr_abs + cfg.reltol * torch.maximum(
            torch.maximum(fro(Ax), fro(Bz)), cnorm)
        if cfg.nodualerror:
            derr = nan
        else:
            derr = math.sqrt(M2) * cfg.abstol + cfg.reltol * fro(rho * A.rmv(u))

        # ---- H-norm / divergence monitor (admm.m:676-703) -------------
        diverged_i = ~torch.isfinite(pnorm) if cfg.nanguard else no
        Hsq = wz_new = wu_new = None
        if needs_h:
            wz_new, wu_new = z, rho * u
            # H uses the setup-time rho (MATLAB closure capture,
            # admm.m:305-306), while w itself carries the current rho.
            Hsq = rho0 * fro2(B.mv(s["wz"] - wz_new)) + rho0 * fro2(s["wu"] - wu_new)
            if cfg.convtest and alg == 0:
                H1, H2 = s["Hprev"], Hsq
                diverged_i = diverged_i | (
                    (i >= 2) & (H1 > eps) & (H2 > H1) & ((H2 - H1) > H1 * cfg.convtol))

        # ---- plateau detector (ADMMConfig.stallwindow) ----------------
        stall_i = no
        best_new = since_new = None
        if use_stall:
            # A NaN pnorm never counts as progress (the comparison is
            # False), so a NaN plateau also trips the window.
            improved = pnorm < s["best_p"] * (1.0 - cfg.stalltol)
            best_new = torch.minimum(s["best_p"], pnorm)
            since_new = torch.where(improved, 0, s["since"] + 1)
            stall_i = since_new >= cfg.stallwindow

        # ---- stopping (admm.m:705-722) --------------------------------
        stop = no
        if alg == 2:
            # Not gated on domaxiters: the reference's accelerated d-value
            # stop ignores it (admm.m:706-707).
            stop = (i >= 2) & (torch.abs(d_new - s["d"]) <= cfg.dvaltol * s["d"])
        elif std_stop and not cfg.domaxiters:
            stop = pnorm < perr
            if not cfg.nodualerror:
                stop = stop & (dnorm < derr)
        if h_stop and not cfg.domaxiters:
            stop = stop | ((i > 2) & (Hsq <= cfg.hnormtol))
        done = stop | diverged_i | stall_i

        # ---- adaptive rho (admm.m:724-741) ----------------------------
        rho_new = rho
        if cfg.adaptive and cfg.convtest:
            rho_new = adaptive_rho_update(cfg, Hprev=s["Hprev"], Hsq=Hsq, rho=rho, i=i,
                                          done=done, eps=eps)
        elif cfg.rbadaptive and alg == 0:
            # Residual balancing with the scaled-dual rescale u * rho/rho_new.
            factor = residual_balance_factor(cfg, pnorm=pnorm, dnorm=dnorm, done=done,
                                             dtype=rdtype)
            rho_new = rho * factor
            u = u / factor

        # ---- Anderson acceleration (anderson.py) ----------------------
        # The plain sweep above is the map T(s); the candidate replaces
        # only the next step's start, after the rbadaptive rescale.
        # Residuals, stop and history stay those of the plain sweep.
        x_next, z_next, u_next = x, z, u
        acnt_new = abest_new = None
        if use_aa:
            flat = lambda a, b, c_: torch.cat((a.reshape(-1), b.reshape(-1), c_.reshape(-1)))
            (s_next,), acnt_new, abest_new, bufs["aF"], bufs["aT"] = window.step(
                [flat(s["x"], s["z"], s["u"])], [flat(x, z, u)], s["acnt"], s["abest"],
                bufs["aF"], bufs["aT"], done=done, frozen=frozen, put=put)
            nx, nz = x.numel(), z.numel()
            x_next = s_next[:nx].reshape(x.shape)
            z_next = s_next[nx:nx + nz].reshape(z.shape)
            u_next = s_next[nx + nz:].reshape(u.shape)

        # ---- history and iterate records (admm.m:596-610) -------------
        vals = ([pnorm, dnorm, perr, derr] + ([obj_fn(x, z)] if record_obj else [])
                + ([Hsq] if needs_h else []) + ([d_new] if alg == 2 else [])
                + ([a_new] if alg else []))
        bufs["hist"] = put(bufs["hist"], 1, slot, torch.stack(vals).reshape(-1, 1))
        if alg == 2:
            bufs["restarted"] = put(bufs["restarted"], 0, slot, restarted_i.reshape(1))
        if record:
            # Under rbadaptive u was rescaled above and rho_new*u keeps the
            # scaled-dual product rho*u_pre; elsewhere w carries the
            # current rho (adaptation comes after recording, admm.m:724).
            w_rho = rho_new if cfg.rbadaptive else rho
            rows = {"xvals": x, "zvals": z, "uvals": u,
                    "wvals": torch.cat((x.reshape(-1), z.reshape(-1), (w_rho * u).reshape(-1)))}
            if alg:
                rows.update(vvals=v_new, uhatvals=uhat_new)
            for name, val in rows.items():
                bufs[name] = put(bufs[name], 0, slot, val.unsqueeze(0))

        return _present(
            k=k + 1, x=x_next, z=z_next, u=u_next, rho=rho_new,
            v=v_new, uhat=uhat_new, a=a_new, d=d_new,
            wz=wz_new, wu=wu_new, Hprev=Hsq,
            best_p=best_new, since=since_new, acnt=acnt_new, abest=abest_new,
            done=done, diverged=s["diverged"] | diverged_i, stalled=s["stalled"] | stall_i,
        ), bufs

    # The whole tail in one launch: K1b for the marked fused_zu hook, its
    # difference-operator mode for a marked TV prox_g on one instance.
    lam_of, tail_fn = None, fused_zu_tail
    if use_fused:
        lam_of = getattr(hooks.fused_zu, "soft_threshold_lam", None)
    elif (not lanes and alg == 0 and not use_relax and hooks.altu is None
          and _tail_computes(cfg, hooks)
          and _diff_tail_applies(prox_g, data, x0, z0, u0, c, A, B)):
        lam_of, tail_fn = prox_g.soft_threshold_lam, fused_diff_tail
    # The callables a sub-step runs.  The chunks run as replays of a CUDA
    # graph of one sub-step (graphs.py) when the device takes one, nothing
    # but the flags is read between chunks, each callable and operator is
    # marked capture-safe, and no autograd or torch.func transform follows
    # the solve.  Anderson's window solves through cuSOLVER and stays eager.
    fns = tuple(f for f in (prox_f, hooks.fused_zu if use_fused else prox_g, hooks.altu,
                            hooks.specialnorms, hooks.obj if record_obj else None)
                if f is not None)
    capture = (graphs.available(device) and cfg.quiet and not use_aa
               and all(graphs.is_capture_safe(f) for f in fns + (type(A), type(B)))
               and not _followed(data, x0, z0, u0, c, A, B))
    kind = (lanes,) + fns
    if lam_of is not None and _tail_computes(cfg, hooks):
        # The soft-threshold pass: the whole tail in one fused_zu_tail (or
        # fused_diff_tail), its freeze select included.
        obj_fn = _bound(hooks.obj, data)
        lam = lam_of(data)
        pf = _bound(prox_f, data)
        hist = bufs["hist"]
        x, z, u = x0.clone(), z0.clone(), u0.clone()  # updated in place
        st = torch.zeros(3, dtype=torch.int64, device=device)  # k, done, diverged
        n_spare = torch.tensor(N, dtype=torch.int64, device=device)
        tail_kw = dict(perr_abs=perr_abs, derr_abs=math.sqrt(float(z.numel())) * cfg.abstol,
                       reltol=cfg.reltol, domaxiters=cfg.domaxiters,
                       nodualerror=cfg.nodualerror, nanguard=cfg.nanguard,
                       scratch=zu_tail_scratch(x.numel(), rdtype, device,
                                               diff=tail_fn is fused_diff_tail))

        def tail_step():
            with span("admm_tpu_torch.step.xupdate"):
                x_new = pf(x, z, u, rho0)
            with span("admm_tpu_torch.step.tail"):
                if record_obj:
                    slot = torch.where((st[1] != 0) | (st[0] >= N), n_spare, st[0])
                tail_fn(x_new, x, z, u, lam, rho0, st, hist, **tail_kw)
                if record_obj:
                    # x and z now hold this step's values unless it was frozen,
                    # and then the write goes to the spare slot.
                    hist[4].index_copy_(0, slot.reshape(1), obj_fn(x, z).reshape(1))

        _run_chunks(tail_step, lambda: st[:2], N, K, None if cfg.quiet else (lambda: hist),
                    graph=graphs.ChunkGraph(device, kind + (tail_fn,)) if capture else None)
        steps, rho, diverged, stalled = st[0], rho0, st[2] != 0, no
    else:
        full = lambda v: torch.full(lead, v, dtype=rdtype, device=device)
        acnt, abest = window.initial(lead) if use_aa else (None, None)
        state = _present(
            k=torch.zeros(lead, dtype=torch.int64, device=device),
            x=x0, z=z0, u=u0, rho=full(cfg.rho),
            v=z0 if alg else None, uhat=u0 if alg else None,
            a=full(1.0) if alg else None,
            d=full(float("inf")) if alg == 2 else None,
            wz=z0 if needs_h else None, wu=rho0 * u0 if needs_h else None,
            Hprev=full(float("inf")) if needs_h else None,
            best_p=full(float("inf")) if use_stall else None,
            since=torch.zeros(lead, dtype=torch.int64, device=device) if use_stall else None,
            acnt=acnt, abest=abest,
            done=torch.zeros(lead, dtype=torch.bool, device=device),
            diverged=torch.zeros(lead, dtype=torch.bool, device=device),
            stalled=torch.zeros(lead, dtype=torch.bool, device=device),
        )
        dims = (0, 0, None if data is None else data_dims) if lanes else None
        s, bufs = run_steps(xupdate, tail, state, bufs, (c, cnorm, data), N, K,
                            data_dims=dims, table=not cfg.quiet,
                            kind=kind if capture else None)
        steps, x, z, u, rho, diverged, stalled = (
            s[key] for key in ("k", "x", "z", "u", "rho", "diverged", "stalled"))

    if hooks.obj is None:
        objopt = None
    elif lanes:
        objopt = torch.func.vmap(lambda x_, z_, d: _bound(hooks.obj, d)(x_, z_),
                                 in_dims=(0, 0, None if data is None else data_dims))(x, z, data)
    else:
        objopt = _bound(hooks.obj, data)(x, z)
    return {
        "steps": steps,
        "xopt": x,
        "zopt": z,
        "uopt": u,
        "rho_final": rho,
        "diverged": diverged,
        "stalled": stalled,
        "hist": traces(names, bufs, N, lanes),
        "objopt": objopt,
    }


def _present(**state):
    """The generic step's state: the fields that the options use."""
    return {key: val for key, val in state.items() if val is not None}


def _followed(data, *objs) -> bool:
    """Whether autograd or a ``torch.func`` transform follows the solve: a
    transform is running, or it follows (``ops/_cuda._traced``) one of
    ``objs``, ``data``'s leaves or the tensors these objects hold."""
    if torch._C._functorch.maybe_current_level() is not None:
        return True
    for v in list(objs) + ([] if data is None else pytree.tree_leaves(data)):
        held = (v,) if isinstance(v, torch.Tensor) else tuple(getattr(v, "__dict__", {}).values())
        if any(isinstance(t, torch.Tensor) and _traced(t) for t in held):
            return True
    return False


def _table_row(i, p, d, pe, de):
    print(f"{i}\tpnorm {p:.4e}\tperr {pe:.4e}\tdnorm {d:.4e}\tderr {de:.4e}")


def _run_chunks(step, flags, N, K, table=None, lane_k=None, graph=None):
    """Run chunks of K steps until ``flags()``, the int64 device tensor
    ``(k, done)``, says the solve is done or at N steps; its one host read
    per chunk is the only one.  With ``table`` (``quiet=False``; it
    returns the history buffer) the read also carries the chunk's columns
    of the first four rows of the history, and the per-iteration table
    (admm.m:318-330, 661-673) prints one row for each live step of the
    chunk, in ``admm_tpu``'s format.

    ``lane_k`` (lanes; it returns the lanes' step counters) prints what
    ``admm_tpu``'s vmapped table prints: under vmap its ``lax.cond`` on
    the live mask becomes a select, so every lane prints a row at every
    sub-step the lanes run.  A live lane prints its step; a frozen one
    (done, or at N steps) prints the step it would take next from its
    frozen state, whose values the freeze select sends to the history's
    spare column N.  Lanes print in lane order at each sub-step (JAX
    prints them in an order of its own).

    With ``graph`` (a ``graphs.ChunkGraph``; never with ``table``) each
    chunk is K replays of a sub-step and the flags, captured from ``step``
    and ``flags`` at the first chunk."""

    def one():
        with span("admm_tpu_torch.step"):
            step()

    with span("admm_tpu_torch.loop"):
        k0 = 0
        while True:
            with span("admm_tpu_torch.chunk"):
                kb = lane_k() if lane_k is not None else None
                if graph is not None:
                    f = graph(one, flags, K)
                else:
                    for _ in range(K):
                        one()
                    f = flags()
                if table is None:
                    k_host, done_host = f.tolist()
                elif lane_k is None:
                    hi = min(k0 + K, N)
                    got = torch.cat((f.double(),
                                     table()[:4, k0:hi].double().reshape(-1))).tolist()
                    k_host, done_host = int(got[0]), got[1]
                    cols = [got[2 + r * (hi - k0): 2 + (r + 1) * (hi - k0)] for r in range(4)]
                    for j in range(k_host - k0):
                        _table_row(k0 + j + 1, *(row[j] for row in cols))
                    k0 = k_host
                else:
                    hist = table()[:, :4]
                    B = hist.shape[0]
                    idx = (kb[:, None] + torch.arange(K, device=kb.device)).clamp(max=N)
                    chunk = hist.gather(2, idx[:, None, :].expand(B, 4, K))  # (B, 4, K)
                    got = torch.cat((f.double(), kb.double(), lane_k().double(),
                                     chunk.double().reshape(-1),
                                     hist[:, :, N].double().reshape(-1)))
                    got = got.tolist()
                    k_host, done_host = int(got[0]), got[1]
                    k_before, k_after = got[2:2 + B], got[2 + B:2 + 2 * B]
                    live = got[2 + 2 * B:2 + 2 * B + 4 * B * K]
                    spare = got[2 + 2 * B + 4 * B * K:]
                    for j in range(K):
                        for b in range(B):
                            if k_before[b] + j < k_after[b]:
                                vals = live[b * 4 * K + j::K][:4]
                                _table_row(int(k_before[b]) + j + 1, *vals)
                            else:
                                _table_row(int(k_after[b]) + 1, *spare[4 * b:4 * b + 4])
            if done_host or k_host >= N:
                return
