"""Standard-form linear program (port of ``admm_tpu/models/linearprogram.py``):

    min b^T x   s.t.   D x = s,  x >= 0

split as f(x) = b^T x + indicator{Dx = s}, g(z) = indicator{z >= 0},
x - z = 0.

Reference: solvers/linearprogram.m (wrapper; KKT caches at :146-157) and
getProxOps.m case 'linearprogram' (:459-542) with proxes xminLinearProgram
(getProxOps.m:1357-1365) and zminLinearProgram (getProxOps.m:1378-1382).

x-update:  KKT solve [rho I, D^T; D, 0] [x; y] = [rho (z - u) - b; s],
           keep the x block
z-update:  max(x + u, 0)

Instead of LU-factoring the (n+m)^2 KKT matrix per rho change (the
reference's approach), the Schur-complement solver of ``ops/solve.py``
eliminates x analytically: static rho folds the whole solve at setup into
one n-by-n GEMV per step, and dynamic rho factors the m-by-m Schur
complement on the device every step without a host read.
"""

from __future__ import annotations

import torch

from ..config import ADMMConfig
from ..device import resolve_device
from ..engine import Hooks, admm
from ..ops.prox import project_nonneg
from ..ops.solve import kkt_eq_solver
from ..results import ADMMResults
from . import register
from ._common import (as_tensor, bind_data, check_data_vector, host64, host_dtype, merge_config,
                      scaled_start, timed_solver, unscale, warn_if_badly_scaled)


def _prox_f(x, z, u, rho, d):
    return d["kkt"].solve(rho * (z - u) - d["b"], d["s"], rho)


def _prox_g(x, z, u, rho, d):
    return project_nonneg(x + u)


def _obj(x, z, d):
    return torch.dot(d["b"], x)


def make_kkt_solver(D, P, s, config: ADMMConfig, kkt_mode: str):
    """The LP/QP-standard x-prox solver: the rho-parameterized Schur solve
    under dynamic rho, else its fixed-rho fold — the affine map (one GEMV
    per step) or, with ``kkt_mode='chol'``, the factored apply."""
    if kkt_mode not in ("affine", "chol"):
        raise ValueError(f"kkt_mode must be 'affine' or 'chol', got {kkt_mode!r}")
    kkt = kkt_eq_solver.from_matrices(D, P)
    if config.dynamic_rho:
        return kkt
    if kkt_mode == "affine":
        return kkt.materialize_affine(config.rho, s)
    return kkt.materialize(config.rho)


def make_prox_ops(b, D, s, config: ADMMConfig = ADMMConfig(), altproxg=None,
                  kkt_mode: str = "affine"):
    """Build (prox_f, prox_g, obj, data) for the LP (getProxOps.m:459-542)
    from tensors on the solve's device.

    Static rho (the default) folds the whole KKT solve at setup into one
    affine map x = K1 b1 + x0 (``kkt_eq_solver.materialize_affine``): a
    single n-by-n GEMV per iteration, no in-loop triangular solves.
    ``kkt_mode='chol'`` keeps the factored apply (two GEMVs + triangular
    pair) for ill-conditioned constraint blocks; dynamic-rho configs use
    the rho-parameterized Schur path regardless.

    ``altproxg(x, z, u, rho, data) -> z`` replaces the nonnegativity
    projection (the reference's args.altproxg, linearprogram.m:162-171)."""
    data = {"b": b, "s": s, "kkt": make_kkt_solver(D, None, s, config, kkt_mode)}
    prox_g = altproxg if altproxg is not None else _prox_g
    return _prox_f, prox_g, _obj, data


@register("linearprogram")
def _registry_entry(b, D, s, config=ADMMConfig(), kkt_mode="affine", device=None, **_):
    device = resolve_device(device, D, b, s)
    D = as_tensor(D).to(device)
    b, s = (as_tensor(v).to(device=device, dtype=D.dtype) for v in (b, s))
    return bind_data(*make_prox_ops(b, D, s, config, kkt_mode=kkt_mode))


@timed_solver
def linearprogram(b=None, D=None, s=None, config: ADMMConfig = ADMMConfig(),
                  altproxg=None, kkt_mode: str = "affine", *,
                  precondition: bool = False, ruiz_iters: int = 15,
                  x0=None, z0=None, u0=None, device=None, **overrides) -> ADMMResults:
    """Solve the standard-form LP (reference solvers/linearprogram.m:81).

    Constraint wiring: A = 1, B = -1, c = 0 in R^n.  ``altproxg``
    replaces the z-prox (reference linearprogram.m:162-171).
    ``kkt_mode``: 'affine' (default — fully-folded one-GEMV x-prox) or
    'chol' (factored apply; see make_prox_ops).  ``b``, ``D`` and ``s``
    are numpy arrays or tensors; the solve runs in D's dtype on
    ``device``, or on the device of the first tensor among D, b, s, or on
    the CUDA device (``device.resolve_device``).

    ``precondition=True`` Ruiz-equilibrates the constraint matrix first
    (``ops/scaling.py``, NumPy f64 on the host; no reference analog) and
    solves the equivalent scaled LP — same optimum and objective value,
    far fewer iterations on badly scaled data.  Returned xopt/zopt/uopt
    are unscaled back; residual traces and the Boyd stop act in the scaled
    space (the OSQP convention); ``results.extra`` carries the scales.
    ``altproxg`` and warm starts then also live in the scaled space
    (x~ = x / e).  The zero-argument demo mode (slice 11) is not ported
    yet and raises ``NotImplementedError``.
    """
    if b is None:
        raise NotImplementedError(
            "linearprogram() demo mode needs the testers of ROADMAP.md queue 1, "
            "slice 11, which are not ported yet")
    check_data_vector(D, s)
    device = resolve_device(device, D, b, s)
    if precondition:
        from ..ops.scaling import ruiz_equilibrate

        dtype = host_dtype(D)
        D64 = host64(D)
        e, rr = ruiz_equilibrate(D64, iters=ruiz_iters)
        Ds = ((rr[:, None] * D64) * e[None, :]).astype(dtype)
        bs = (e * host64(b)).astype(dtype)
        ss = (rr * host64(s)).astype(dtype)
        res = linearprogram(bs, Ds, ss, config, altproxg, kkt_mode, device=device,
                            **scaled_start(e, x0, z0, u0), **overrides)
        return unscale(res, e, rr)
    warn_if_badly_scaled(D, None)
    # affine mode is a one-GEMV body ('gemv'); the factored chol apply is
    # triangular-sweep dominated ('heavy').
    config = merge_config(config, overrides,
                          body="gemv" if kkt_mode == "affine" else "heavy")
    D = as_tensor(D).to(device)
    b, s = (as_tensor(v).to(device=device, dtype=D.dtype) for v in (b, s))
    n = D.shape[1]
    prox_f, prox_g, obj, data = make_prox_ops(b, D, s, config, altproxg=altproxg,
                                              kkt_mode=kkt_mode)
    return admm(
        prox_f, prox_g, config,
        A=1.0, B=-1.0, c=0.0, m=n, nA=n, nB=n,
        x0=x0, z0=z0, u0=u0,
        hooks=Hooks(obj=obj), dtype=D.dtype, data=data, device=device,
    )
