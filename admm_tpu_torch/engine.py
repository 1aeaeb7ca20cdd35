"""The core ADMM engine (port of ``admm_tpu/engine.py``).

``admm_tpu`` compiles the whole solve into one ``lax.while_loop`` whose
body runs K = ``config.unroll`` exact sub-steps.  Here the loop is a
Python loop over chunks of K sub-steps that run eagerly on the solve's
device:

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

The step runs every variant of ``admm_tpu``'s engine (engine.py:575-880):
fast (alg 1) and accelerated (alg 2) ADMM with restart and d-values, the
H-norm stop and ``convtest`` monitor, adaptive and residual-balancing rho,
the stall detector, Anderson acceleration (``anderson.py``), the iterate
records, relaxation, and the ``altu``, ``specialnorms``, ``preprocess``,
``obj`` and ``fused_zu`` hooks.  Only ``parallel=`` (ROADMAP.md queue 1,
slice 10) is not ported and raises ``NotImplementedError``.

When the ``fused_zu`` hook is the soft-threshold pass
(``ops/kernels.soft_threshold_pass``, lasso's ``use_fused_kernel``) and
the options ask for nothing beyond the standard stop, a step is ``prox_f``
plus one ``ops/kernels.fused_zu_tail``: the z/u pass, norms, Boyd errors,
flags, history write and freeze select in one launch of K1b on the card.
That path keeps k, done and diverged in one int64 device tensor and
updates its x, z and u in place: the engine copies x0, z0 and u0 once at
the start, so a caller's tensors are never written.  Any option the tail
does not compute (``_tail_computes``) takes the generic step, with the
hook's z/u pass (K1's z/u mode) in place of ``prox_g``.
"""

from __future__ import annotations

import math
import time
from typing import Callable, NamedTuple, Optional

import numpy as np
import torch

from .anderson import AndersonWindow
from .config import ADMMConfig, matmul_precision, resolve_unroll
from .device import resolve_device
from .linop import ScaledIdentityOp, as_linop
from .ops.kernels import fused_zu_tail, zu_tail_scratch
from .results import ADMMResults


def _fro2(v):
    """Squared Frobenius norm."""
    return torch.sum(v * v)


def _fro(v):
    return torch.sqrt(_fro2(v))


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


class _State(NamedTuple):
    """The carry of the generic step (``admm_tpu``'s ``_Carry``); a field
    an option does not use is None."""

    k: torch.Tensor         # int64: completed iterations
    x: torch.Tensor
    z: torch.Tensor
    u: torch.Tensor
    rho: torch.Tensor       # 0-d
    v: Optional[torch.Tensor]      # fast/accelerated z-predictor
    uhat: Optional[torch.Tensor]   # and u-predictor
    a: Optional[torch.Tensor]      # momentum
    d: Optional[torch.Tensor]      # accelerated d-value
    wz: Optional[torch.Tensor]     # previous w's z-part
    wu: Optional[torch.Tensor]     # and (rho*u)-part
    Hprev: Optional[torch.Tensor]  # previous H-norm^2
    best_p: Optional[torch.Tensor]  # stall detector: best pnorm
    since: Optional[torch.Tensor]   # and steps without progress
    acnt: Optional[torch.Tensor]    # Anderson: window count
    abest: Optional[torch.Tensor]   # and best residual norm^2
    done: torch.Tensor      # bool
    diverged: torch.Tensor  # bool
    stalled: torch.Tensor   # bool


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


def _check_ported(parallel) -> None:
    """Refuse what this engine does not run yet, naming where in
    ROADMAP.md (queue 1) it is planned."""
    if parallel is not None:
        raise NotImplementedError(
            "admm_tpu_torch.engine: parallel= is not ported yet "
            "(ROADMAP.md queue 1, slice 10)")


def _sync(device):
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
    one, or torch's default.  ``parallel=`` is not ported yet
    (ROADMAP slice 10) and raises.
    """
    _check_ported(parallel)
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

    if hooks.fused_zu is not None:
        _check_fused_splitting(A, B, c_arr)

    if hooks.preprocess is not None:
        # Hooks follow the data convention (trailing data arg when given).
        hooks.preprocess(data) if data is not None else hooks.preprocess()

    _sync(device)
    t0 = time.perf_counter()
    with matmul_precision(config.matmul_precision):
        raw = _run(prox_f, prox_g, config, hooks, data, x0, z0, u0, c_arr, A, B)
    _sync(device)
    runtime = time.perf_counter() - t0
    res = ADMMResults.from_raw(raw, config, x0=x0, z0=z0, u0=u0)
    res.runtime = runtime
    if not config.quiet:
        # Final summary line (reference admm.m:759-765).
        print(f"ADMM finished: {res.steps} steps in {res.runtime:.4f}s"
              + (", DIVERGED" if res.diverged else ""))
    return res


def _as_tensor(v):
    return v if isinstance(v, torch.Tensor) else torch.as_tensor(np.asarray(v))


def _check_fused_splitting(A, B, c):
    """hooks.fused_zu assumes the plain splitting A = I, B = -I, c = 0 —
    its dual update is u + x - z.  Any other A/B/c would make it silently
    wrong, so refuse up front."""

    def _is(op, val):
        return isinstance(op, ScaledIdentityOp) and float(op.alpha) == val

    if not (_is(A, 1.0) and _is(B, -1.0)):
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


def _run(prox_f, prox_g, cfg: ADMMConfig, hooks: Hooks, data,
         x0, z0, u0, c, A, B) -> dict:
    """The loop (``admm_tpu`` engine.py:483-897).  Returns the raw result
    dict."""
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

    if data is not None:
        bind = lambda fn: (lambda *a: fn(*a, data)) if fn is not None else None
    else:
        bind = lambda fn: fn
    pf, pg = bind(prox_f), bind(prox_g)
    obj_fn, altu_fn, norms_fn, fused_fn = (
        bind(h) for h in (hooks.obj, hooks.altu, hooks.specialnorms, hooks.fused_zu))
    # Fused z+dual path applies only to the plain splitting (admm_tpu
    # engine.py:519-522).
    use_fused = fused_fn is not None and alg == 0 and not use_relax and altu_fn is None
    record_obj = cfg.objevals and obj_fn is not None

    rho0 = torch.tensor(cfg.rho, dtype=rdtype, device=device)
    eps = torch.finfo(rdtype).eps
    cnorm = _fro(c)
    # Static element counts M1/M2 for Boyd errors (admm.m:644-645).
    perr_abs = math.sqrt(float(c.numel())) * cfg.abstol
    nan = torch.tensor(float("nan"), dtype=rdtype, device=device)
    n_spare = torch.tensor(N, dtype=torch.int64, device=device)
    no = torch.zeros((), dtype=torch.bool, device=device)
    scalar = lambda v: torch.as_tensor(v, dtype=rdtype, device=device)

    # Scalar traces, one row each; column N is the spare slot that frozen
    # sub-steps write to (sliced off at the end).
    names = (["pnorm", "dnorm", "perr", "derr"] + (["objvals"] if record_obj else [])
             + (["Hnormsq"] if needs_h else []) + (["dvals"] if alg == 2 else [])
             + (["avals"] if alg else []))
    hist = torch.full((len(names), N + 1), float("nan"), dtype=rdtype, device=device)
    # Traces of other shapes: the int restart flags and the iterate
    # records, leading axis N + 1 with the same spare slot.
    extra = {}
    if alg == 2:
        extra["restarted"] = torch.zeros(N + 1, dtype=torch.int32, device=device)
    if record:
        for name, like in (("xvals", x0), ("zvals", z0), ("uvals", u0)) + (
                (("vvals", z0), ("uhatvals", u0)) if alg else ()):
            extra[name] = torch.zeros((N + 1,) + tuple(like.shape), dtype=rdtype, device=device)
        extra["wvals"] = torch.zeros((N + 1, x0.numel() + z0.numel() + u0.numel()),
                                     dtype=rdtype, device=device)
    window = AndersonWindow(cfg, [x0.numel() + z0.numel() + u0.numel()], dtype=rdtype,
                            device=device) if use_aa else None

    def step(s: _State) -> _State:
        # frozen gates this sub-step; at K = 1 the host checks k and done
        # before every step, so nothing is ever frozen and no select runs.
        frozen = (s.done | (s.k >= N)) if K > 1 else None
        k, rho = s.k, s.rho
        i = k + 1  # the reference's 1-based iteration counter
        x, z, u = s.x, s.z, s.u
        zprev = z

        # ---- x-update (admm.m:501-511) --------------------------------
        if alg == 0:
            x = pf(x, z, u, rho)
            uhat = u
        else:
            uprev, uhat = u, s.uhat
            x = pf(x, s.v, uhat, rho)

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
        v_new, uhat_new, a_new, d_new, restarted_i = s.v, s.uhat, s.a, s.d, None
        if alg:
            dval = ((1.0 / rho) * _fro2(u - uhat) + rho * _fro2(B.mv(z - s.v))
                    if alg == 2 else None)
            v_new, uhat_new, a_new, d2, r2 = fast_update(
                alg, cfg, aprev=s.a, dprev=s.d, z=z, zprev=zprev, u=u, uprev=uprev,
                v=s.v, dval=dval)
            if alg == 2:
                d_new, restarted_i = d2, r2

        # ---- norms (admm.m:612-637) -----------------------------------
        if norms_fn is not None:
            pnorm, dnorm = (scalar(v) for v in norms_fn(x, z, u, rho))
        else:
            pnorm = _fro(Ax + Bz - c)
            if cfg.nodualerror:
                dnorm = nan
            elif alg == 1:
                dnorm = rho * _fro(A.rmv(B.mv(z - v_new)))
            else:  # alg 0 (and alg 2, recorded for observability)
                dnorm = _fro(rho * A.rmv(B.mv(z - zprev)))

        # ---- Boyd errors (admm.m:639-658) -----------------------------
        M2 = float(Bz.numel())
        perr = perr_abs + cfg.reltol * torch.maximum(
            torch.maximum(_fro(Ax), _fro(Bz)), cnorm)
        if cfg.nodualerror:
            derr = nan
        else:
            derr = math.sqrt(M2) * cfg.abstol + cfg.reltol * _fro(rho * A.rmv(u))

        # ---- H-norm / divergence monitor (admm.m:676-703) -------------
        diverged_i = ~torch.isfinite(pnorm) if cfg.nanguard else no
        Hsq = wz_new = wu_new = None
        if needs_h:
            wz_new, wu_new = z, rho * u
            # H uses the setup-time rho (MATLAB closure capture,
            # admm.m:305-306), while w itself carries the current rho.
            Hsq = rho0 * _fro2(B.mv(s.wz - wz_new)) + rho0 * _fro2(s.wu - wu_new)
            if cfg.convtest and alg == 0:
                H1, H2 = s.Hprev, Hsq
                diverged_i = diverged_i | (
                    (i >= 2) & (H1 > eps) & (H2 > H1) & ((H2 - H1) > H1 * cfg.convtol))

        # ---- plateau detector (ADMMConfig.stallwindow) ----------------
        stall_i = no
        best_new = since_new = None
        if use_stall:
            # A NaN pnorm never counts as progress (the comparison is
            # False), so a NaN plateau also trips the window.
            improved = pnorm < s.best_p * (1.0 - cfg.stalltol)
            best_new = torch.minimum(s.best_p, pnorm)
            since_new = torch.where(improved, 0, s.since + 1)
            stall_i = since_new >= cfg.stallwindow

        # ---- stopping (admm.m:705-722) --------------------------------
        stop = no
        if alg == 2:
            # Not gated on domaxiters: the reference's accelerated d-value
            # stop ignores it (admm.m:706-707).
            stop = (i >= 2) & (torch.abs(d_new - s.d) <= cfg.dvaltol * s.d)
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
            rho_new = adaptive_rho_update(cfg, Hprev=s.Hprev, Hsq=Hsq, rho=rho, i=i,
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
            (s_next,), acnt_new, abest_new = window.step(
                [flat(s.x, s.z, s.u)], [flat(x, z, u)], s.acnt, s.abest,
                done=done, frozen=frozen)
            nx, nz = x.numel(), z.numel()
            x_next = s_next[:nx].reshape(x.shape)
            z_next = s_next[nx:nx + nz].reshape(z.shape)
            u_next = s_next[nx + nz:].reshape(u.shape)

        # ---- history and iterate records (admm.m:596-610) -------------
        slot = (k if frozen is None else torch.where(frozen, n_spare, k)).reshape(1)
        vals = ([pnorm, dnorm, perr, derr] + ([obj_fn(x, z)] if record_obj else [])
                + ([Hsq] if needs_h else []) + ([d_new] if alg == 2 else [])
                + ([a_new] if alg else []))
        hist.index_copy_(1, slot, torch.stack(vals).reshape(-1, 1))
        if alg == 2:
            extra["restarted"].index_copy_(0, slot, restarted_i.reshape(1))
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
                extra[name].index_copy_(0, slot, val.unsqueeze(0))

        new = _State(
            k=k + 1, x=x_next, z=z_next, u=u_next, rho=rho_new,
            v=v_new, uhat=uhat_new, a=a_new, d=d_new,
            wz=wz_new, wu=wu_new, Hprev=Hsq,
            best_p=best_new, since=since_new, acnt=acnt_new, abest=abest_new,
            done=done, diverged=s.diverged | diverged_i, stalled=s.stalled | stall_i,
        )
        if frozen is None:
            return new
        return _State(*(None if b is None else torch.where(frozen, a, b)
                        for a, b in zip(s, new)))

    lam_of = getattr(hooks.fused_zu, "soft_threshold_lam", None) if use_fused else None
    table = None if cfg.quiet else hist
    if lam_of is not None and _tail_computes(cfg, hooks):
        # The soft-threshold pass: the whole tail in one fused_zu_tail.
        lam = lam_of(data)
        x, z, u = x0.clone(), z0.clone(), u0.clone()  # updated in place
        st = torch.zeros(3, dtype=torch.int64, device=device)  # k, done, diverged
        tail_kw = dict(perr_abs=perr_abs, derr_abs=math.sqrt(float(z.numel())) * cfg.abstol,
                       reltol=cfg.reltol, domaxiters=cfg.domaxiters,
                       nodualerror=cfg.nodualerror, nanguard=cfg.nanguard,
                       scratch=zu_tail_scratch(x.numel(), rdtype, device))

        def tail_step():
            if record_obj:
                slot = torch.where((st[1] != 0) | (st[0] >= N), n_spare, st[0])
            fused_zu_tail(pf(x, z, u, rho0), x, z, u, lam, rho0, st, hist, **tail_kw)
            if record_obj:
                # x and z now hold this step's values unless it was frozen,
                # and then the write goes to the spare slot.
                hist[4].index_copy_(0, slot.reshape(1), obj_fn(x, z).reshape(1))

        _run_chunks(tail_step, lambda: st[:2], N, K, table)
        steps, rho, diverged, stalled = st[0], rho0, st[2] != 0, no
    else:
        acnt, abest = window.initial() if use_aa else (None, None)
        s = _State(
            k=torch.zeros((), dtype=torch.int64, device=device),
            x=x0, z=z0, u=u0, rho=rho0,
            v=z0 if alg else None, uhat=u0 if alg else None,
            a=scalar(1.0) if alg else None,
            d=scalar(float("inf")) if alg == 2 else None,
            wz=z0 if needs_h else None, wu=rho0 * u0 if needs_h else None,
            Hprev=scalar(float("inf")) if needs_h else None,
            best_p=scalar(float("inf")) if use_stall else None,
            since=torch.zeros((), dtype=torch.int64, device=device) if use_stall else None,
            acnt=acnt, abest=abest,
            done=no, diverged=no, stalled=no,
        )

        def generic_step():
            nonlocal s
            s = step(s)

        _run_chunks(generic_step, lambda: torch.stack((s.k, s.done.long())), N, K, table)
        steps, x, z, u, rho, diverged, stalled = s.k, s.x, s.z, s.u, s.rho, s.diverged, s.stalled

    traces = {name: hist[i, :N] for i, name in enumerate(names)}
    traces.update({name: buf[:N] for name, buf in extra.items()})
    return {
        "steps": steps,
        "xopt": x,
        "zopt": z,
        "uopt": u,
        "rho_final": rho,
        "diverged": diverged,
        "stalled": stalled,
        "hist": traces,
        "objopt": obj_fn(x, z) if obj_fn is not None else None,
    }


def _run_chunks(step, flags, N, K, table=None):
    """Run chunks of K steps until ``flags()``, the int64 device tensor
    ``(k, done)``, says the solve is done or at N steps; its one host read
    per chunk is the only one.  With ``table`` (``quiet=False``) the read
    also carries the chunk's columns of the first four rows of the
    history, and the per-iteration table (admm.m:318-330, 661-673) prints
    one row for each live step of the chunk, in ``admm_tpu``'s format."""
    k0 = 0
    while True:
        for _ in range(K):
            step()
        if table is None:
            k_host, done_host = flags().tolist()
        else:
            hi = min(k0 + K, N)
            got = torch.cat((flags().double(), table[:4, k0:hi].double().reshape(-1))).tolist()
            k_host, done_host = int(got[0]), got[1]
            cols = [got[2 + r * (hi - k0): 2 + (r + 1) * (hi - k0)] for r in range(4)]
            for j in range(k_host - k0):
                p, d, pe, de = (row[j] for row in cols)
                print(f"{k0 + j + 1}\tpnorm {p:.4e}\tperr {pe:.4e}\tdnorm {d:.4e}"
                      f"\tderr {de:.4e}")
            k0 = k_host
        if done_host or k_host >= N:
            return
