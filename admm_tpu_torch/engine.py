"""The core ADMM engine (port of ``admm_tpu/engine.py``, alg 0).

``admm_tpu`` compiles the whole solve into one ``lax.while_loop`` whose
body runs K = ``config.unroll`` exact sub-steps.  Here the loop is a
Python loop over chunks of K sub-steps that run eagerly on the solve's
device:

  * every sub-step computes ``frozen = done | (k >= N)`` on the device and
    selects the new state against it with ``torch.where``, and its history
    write goes to a spare slot past the end when it is frozen, so results,
    step counts and histories equal K = 1 exactly (``admm_tpu``'s
    ``unrolled_body`` / ``freeze_helpers``, engine.py:392-445);
  * the host reads ``k`` and ``done`` once per chunk and nowhere else;
  * rho is a 0-d device tensor, so nothing in a chunk waits on the host.

Ported: shape and initial-state resolution, the ``fused_zu`` hook with its
splitting check, ``relax``, the standard stop, ``domaxiters``,
``nodualerror``, ``nanguard``, ``objevals`` / ``objopt``, the per-iteration
pnorm/dnorm/perr/derr histories, and the final summary line of
``quiet=False``.  Every other option and hook raises ``NotImplementedError``
naming its ROADMAP slice (``_check_ported``).
"""

from __future__ import annotations

import math
import time
from typing import Callable, NamedTuple, Optional

import numpy as np
import torch

from .config import ADMMConfig, matmul_precision, resolve_unroll
from .linop import ScaledIdentityOp, as_linop
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
    k: torch.Tensor         # int64: completed iterations
    x: torch.Tensor
    z: torch.Tensor
    u: torch.Tensor
    done: torch.Tensor      # bool
    diverged: torch.Tensor  # bool


def _check_ported(config: ADMMConfig, hooks: Hooks, parallel) -> None:
    """Refuse what this engine does not run yet, naming where in
    ROADMAP.md (queue 1) it is planned."""
    pending = (
        ("fast", config.fast, "slice 2"),
        (f"stopcond={config.stopcond!r} (H-norm stop)",
         config.stopcond != "standard", "slice 2"),
        ("convtest", config.convtest, "slice 2"),
        ("adaptive", config.adaptive, "slice 2"),
        ("rbadaptive", config.rbadaptive, "slice 2"),
        ("stallwindow", config.use_stall, "slice 2"),
        ("anderson", config.anderson > 0, "slice 2"),
        ("record_iterates", config.record_iterates, "slice 2"),
        ("hooks.altu", hooks.altu is not None, "slice 2"),
        ("hooks.specialnorms", hooks.specialnorms is not None, "slice 2"),
        ("hooks.preprocess", hooks.preprocess is not None, "slice 2"),
        ("parallel=", parallel is not None, "slice 10"),
    )
    for name, on, where in pending:
        if on:
            raise NotImplementedError(
                f"admm_tpu_torch.engine: {name} is not ported yet "
                f"(ROADMAP.md queue 1, {where})")


def _tensors(*objs):
    for o in objs:
        if isinstance(o, dict):
            yield from _tensors(*o.values())
        elif isinstance(o, torch.Tensor):
            yield o


def _resolve_device(device, *candidates):
    """``device`` if given, else that of the first tensor among the
    candidates (dict values included), else the CPU."""
    if device is not None:
        return torch.device(device)
    return next((t.device for t in _tensors(*candidates)), torch.device("cpu"))


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
    ``data`` is given, every callable takes it as an extra trailing
    argument, as in ``admm_tpu``.

    The solve runs on ``device``, or on the device of the first tensor
    among x0, z0, u0, c, A, B and ``data``'s values, or on the CPU.  The
    dtype is ``dtype``, or that of the first of x0, z0, u0, c that has
    one, or torch's default.  ``parallel=`` is not ported yet
    (ROADMAP slice 10) and raises.
    """
    _check_ported(config, hooks, parallel)
    config = resolve_unroll(config, "default")
    device = _resolve_device(device, x0, z0, u0, c, A, B, data)

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


def _run(prox_f, prox_g, cfg: ADMMConfig, hooks: Hooks, data,
         x0, z0, u0, c, A, B) -> dict:
    """The alg-0 loop (admm_tpu engine.py:483-897 without the branches
    ``_check_ported`` refuses).  Returns the raw result dict."""
    N = int(cfg.maxiters)
    K = int(cfg.unroll)
    relax = float(cfg.relax)
    use_relax = relax != 1.0
    device, rdtype = x0.device, x0.dtype

    if data is not None:
        pf = lambda *a: prox_f(*a, data)
        pg = lambda *a: prox_g(*a, data)
        obj_fn = (lambda x, z: hooks.obj(x, z, data)) if hooks.obj else None
        fused_fn = ((lambda x, u, rho: hooks.fused_zu(x, u, rho, data))
                    if hooks.fused_zu else None)
    else:
        pf, pg, obj_fn, fused_fn = prox_f, prox_g, hooks.obj, hooks.fused_zu
    # Fused z+dual path applies only to the plain splitting, alg 0, no
    # relaxation and no altu (admm_tpu engine.py:519-522); _check_ported
    # has already refused alg != 0 and altu.
    use_fused = fused_fn is not None and not use_relax
    record_obj = cfg.objevals and obj_fn is not None

    rho = torch.tensor(cfg.rho, dtype=rdtype, device=device)
    cnorm = _fro(c)
    # Static element counts M1/M2 for Boyd errors (admm.m:644-645).
    perr_abs = math.sqrt(float(c.numel())) * cfg.abstol
    nan = torch.tensor(float("nan"), dtype=rdtype, device=device)
    n_spare = torch.tensor(N, dtype=torch.int64, device=device)
    no = torch.zeros((), dtype=torch.bool, device=device)

    # Rows pnorm, dnorm, perr, derr[, objvals]; column N is the spare slot
    # that frozen sub-steps write to (sliced off at the end).
    names = ["pnorm", "dnorm", "perr", "derr"] + (["objvals"] if record_obj else [])
    hist = torch.full((len(names), N + 1), float("nan"), dtype=rdtype, device=device)

    def step(s: _State) -> _State:
        # frozen gates this sub-step; at K = 1 the host checks k and done
        # before every step, so nothing is ever frozen and no select runs.
        frozen = (s.done | (s.k >= N)) if K > 1 else None
        x, z, u = s.x, s.z, s.u
        zprev = z

        # ---- x-update (admm.m:501-511) --------------------------------
        x = pf(x, z, u, rho)

        # ---- relaxation + z-update (admm.m:515-532) -------------------
        Ax_for_g = x
        Axhat = None
        if use_relax:
            Axhat = relax * A.mv(x) - (1.0 - relax) * (B.mv(zprev) - c)
            Ax_for_g = Axhat
        if use_fused:
            z, u_fused = fused_fn(x, u, rho)
        else:
            z = pg(Ax_for_g, z, u, rho)

        Ax = A.mv(x)
        Bz = B.mv(z)
        Axr = Axhat if use_relax else Ax

        # ---- dual update (admm.m:538-560) -----------------------------
        u = u_fused if use_fused else u + (Axr + Bz - c)

        # ---- norms (admm.m:612-637) -----------------------------------
        pnorm = _fro(Ax + Bz - c)
        if cfg.nodualerror:
            dnorm = nan
        else:
            dnorm = _fro(rho * A.rmv(B.mv(z - zprev)))

        # ---- Boyd errors (admm.m:639-658) -----------------------------
        M2 = float(Bz.numel())
        perr = perr_abs + cfg.reltol * torch.maximum(
            torch.maximum(_fro(Ax), _fro(Bz)), cnorm)
        if cfg.nodualerror:
            derr = nan
        else:
            derr = math.sqrt(M2) * cfg.abstol + cfg.reltol * _fro(rho * A.rmv(u))

        # ---- divergence guard and stopping (admm.m:705-722) -----------
        diverged_i = ~torch.isfinite(pnorm) if cfg.nanguard else no
        stop = no
        if not cfg.domaxiters:
            stop = pnorm < perr
            if not cfg.nodualerror:
                stop = stop & (dnorm < derr)
        done = stop | diverged_i

        # ---- history (admm.m:596-610) ---------------------------------
        vals = [pnorm, dnorm, perr, derr] + ([obj_fn(x, z)] if record_obj else [])
        slot = s.k if frozen is None else torch.where(frozen, n_spare, s.k)
        hist.index_copy_(1, slot.reshape(1), torch.stack(vals).reshape(-1, 1))

        if frozen is None:
            return _State(s.k + 1, x, z, u, done, s.diverged | diverged_i)
        sel = lambda old, new: torch.where(frozen, old, new)
        return _State(
            k=sel(s.k, s.k + 1),
            x=sel(s.x, x), z=sel(s.z, z), u=sel(s.u, u),
            done=sel(s.done, done),
            diverged=sel(s.diverged, s.diverged | diverged_i),
        )

    s = _State(
        k=torch.zeros((), dtype=torch.int64, device=device),
        x=x0, z=z0, u=u0, done=no, diverged=no,
    )
    while True:
        for _ in range(K):
            s = step(s)
        # The one host read per chunk.
        k_host, done_host = torch.stack((s.k, s.done.long())).tolist()
        if done_host or k_host >= N:
            break

    return {
        "steps": s.k,
        "xopt": s.x,
        "zopt": s.z,
        "uopt": s.u,
        "rho_final": rho,
        "diverged": s.diverged,
        "hist": {name: hist[i, :N] for i, name in enumerate(names)},
        "objopt": obj_fn(s.x, s.z) if obj_fn is not None else None,
    }
