"""Shared solver-wrapper plumbing (port of ``admm_tpu/models/_common.py``:
``merge_config``, ``bind_data``, ``check_data_vector``,
``normal_equations_data`` and ``timed_solver``; the port's own
``as_tensor`` and ``place_data``)."""

from __future__ import annotations

import dataclasses
import time
from functools import wraps

import numpy as np
import torch

from ..config import ADMMConfig, matmul_precision, resolve_unroll
from ..device import resolve_device


def merge_config(config: ADMMConfig, overrides: dict,
                 body: str = "default") -> ADMMConfig:
    """Apply keyword overrides to a config (the reference's pattern of
    solvers mutating the options struct before calling admm), then
    resolve ``unroll='auto'`` for the wrapper's iteration-body class."""
    if overrides:
        config = dataclasses.replace(config, **overrides)
    return resolve_unroll(config, body)


def bind_data(prox_f, prox_g, obj, data):
    """Close data-convention functions over concrete operands, recovering
    the reference's closure-style prox handles (getproxops returns
    closures over cached factorizations, getProxOps.m:13-31).  For the
    string registry / ad-hoc use only: solvers pass ``data`` through the
    engine."""
    pf = None if prox_f is None else (lambda x, z, u, rho: prox_f(x, z, u, rho, data))
    pg = None if prox_g is None else (lambda x, z, u, rho: prox_g(x, z, u, rho, data))
    ob = None if obj is None else (lambda x, z: obj(x, z, data))
    return pf, pg, ob


def check_data_vector(D, s, Dname="D", sname="s"):
    """Shape cross-check shared by the regression-style solvers (the
    reference's per-solver errorcheck subfunctions, e.g. lasso.m:132-141):
    D must be 2-D and s a vector of length rows(D).  Takes numpy arrays or
    tensors."""
    Dsh = tuple(np.shape(D))
    ssh = tuple(np.shape(s))
    if len(Dsh) != 2:
        raise ValueError(f"{Dname} must be 2-D, got shape {Dsh}")
    if len(ssh) != 1 or ssh[0] != Dsh[0]:
        raise ValueError(
            f"{sname} must be a vector of length {Dsh[0]} (rows of {Dname}), "
            f"got shape {ssh}"
        )


def normal_equations_data(D, s):
    """Shared LAD/Huber/quantile setup: validate the skinny shape and
    materialize the normal-equations pseudo-inverse (D^T D)^{-1} D^T once
    (the f == 0 x-update through D; getProxOps.m:753-912).  ``D`` and
    ``s`` are tensors on the solve's device."""
    check_data_vector(D, s)
    if D.shape[0] < D.shape[1]:
        raise ValueError(
            f"D must have at least as many rows as columns "
            f"(normal equations D^T D must be invertible), got {tuple(D.shape)}"
        )
    return {"D": D, "s": s, "Dplus": torch.linalg.solve(D.T @ D, D.T)}


def as_tensor(v):
    """``v`` itself if it is a tensor, else a CPU tensor of its numbers."""
    return v if isinstance(v, torch.Tensor) else torch.as_tensor(np.asarray(v))


def place_data(D, s, device=None):
    """``(D, s, device)`` for a regression-style solve, the device chosen
    by ``resolve_device``; D (numpy array or tensor) keeps its dtype and
    s takes D's."""
    device = resolve_device(device, D, s)
    D = as_tensor(D).to(device)
    return D, as_tensor(s).to(device=device, dtype=D.dtype), device


def timed_solver(fn):
    """Record whole-solver wall time as ``results.solverruntime``
    (reference: tic/toc around each solver, e.g. solvers/lasso.m:117,243).

    Also pins float32 matmuls to full precision (no TF32) for the solver's
    setup computations (Grams, factorizations): reduced-precision passes
    corrupt the solver algebra.  The pin is set for the call and the
    caller's settings are restored afterwards, so a global TF32 setting
    neither leaks in nor is changed.  The loop itself runs under
    ``config.matmul_precision`` (the engine sets it)."""

    @wraps(fn)
    def wrapper(*args, **kwargs):
        t0 = time.perf_counter()
        with matmul_precision("highest"):
            results = fn(*args, **kwargs)
        results.solverruntime = time.perf_counter() - t0
        return results

    return wrapper


def warn_if_badly_scaled(D, P, bar: float = 1e5):
    """The LP's and QP's one-line steer toward precondition=True when the
    KKT row-norm spread says plain ADMM will struggle (no reference analog
    — its testers only generate well-scaled data).  Runs only for numpy inputs
    of bounded size, as in ``admm_tpu``: tensors would pay a copy to the
    host per solve, and repeat solves at benchmark sizes would bill an
    O(mn) f64 scan to every call just to stay silent."""
    import warnings

    if not isinstance(D, np.ndarray) or D.size > 4_000_000:
        return
    if P is not None and (not isinstance(P, np.ndarray) or P.size > 4_000_000):
        return

    from ..ops.scaling import kkt_scale_quality

    q = kkt_scale_quality(D, P)
    if q > bar:
        warnings.warn(
            f"constraint data is badly scaled (KKT row-norm spread "
            f"{q:.1e}); plain ADMM may converge slowly or stall — "
            f"consider precondition=True (Ruiz equilibration)",
            RuntimeWarning, stacklevel=4)


def host64(v):
    """``v`` (numpy array or tensor, on any device) as a host f64 array,
    or None."""
    return None if v is None else as_tensor(v).to("cpu", torch.float64).numpy()


def host_dtype(v):
    """The numpy dtype of ``v``'s numbers (a numpy array's or a tensor's)."""
    return as_tensor(v)[:0].cpu().numpy().dtype


def scaled_start(e, x0, z0, u0):
    """A warm start in the scaled space of a preconditioned solve:
    x~ = x / e, z~ = z / e and the scaled dual the other way, u~ = e u
    (dg~(x~) = E dg(x), so rho u~ = E (rho u))."""
    def f(v, op):
        return None if v is None else op(host64(v))

    return dict(x0=f(x0, lambda v: v / e), z0=f(z0, lambda v: v / e), u0=f(u0, lambda v: v * e))


def unscale(res, e, rr):
    """Map a preconditioned solve back: x = e x~, z = e z~, and the scaled
    dual the other way, u = u~ / e; the scales go to ``results.extra``."""
    ev = torch.as_tensor(e, dtype=res.xopt.dtype, device=res.xopt.device)
    res.xopt = ev * res.xopt
    res.zopt = ev * res.zopt
    res.uopt = res.uopt / ev
    res.extra = {**(res.extra or {}), "ruiz_col": e, "ruiz_row": rr}
    return res
