"""L1-regularized (sparse) logistic regression (port of
``admm_tpu/models/logreg.py``):

    min  sum_i log(1 + exp(-ell_i d_i^T x)) + lam ||z||_1
    s.t. x - z = 0

Boyd et al. 2011, sec. 8.2; beyond the reference library, whose nearest
relatives are the SVM hinge solvers (getProxOps.m:202-310).

The x-prox has no closed form: it minimizes the smooth, rho-strongly
convex  f(x) + (rho/2)||x - (z - u)||^2  with a fixed number of damped
Newton steps.  ``inner='newton'`` builds the Hessian
D^T diag(w) D + rho I (symmetric positive definite, its spectrum above
rho) and solves it by Cholesky (``ops/solve.cho_factor``/``cho_solve``:
``cholesky_ex`` and two triangular solves, where ``admm_tpu`` takes an LU
solve); no status is read back, so a step makes no host read; a single
objective-gated halving (a ``torch.where``, not a branch) keeps each step
safe.  ``inner='newton_cg'`` solves the Newton system matrix-free with a
fixed number of Jacobi-preconditioned CG steps (two (m, n) products per
CG step, no (n, n) Hessian), the form that batches well over lanes.  The
z-prox is the soft threshold.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from ..config import ADMMConfig
from ..engine import Hooks, admm
from ..ops.prox import soft_threshold
from ..ops.solve import cho_factor, cho_solve
from ..results import ADMMResults
from . import register
from ._common import bind_data, check_data_vector, host64, merge_config, place_data, timed_solver

# Inner Newton steps per x-prox evaluation (admm_tpu's default).
_NEWTON_STEPS = 5


def _softplus_neg(t):
    # log(1 + exp(-t)), stably, as jnp.logaddexp(0, -t).
    return torch.logaddexp(torch.zeros_like(t), -t)


def _prox_objective(x, v, rho, d):
    t = d["ell"] * (d["D"] @ x)  # (m,) margins  y_i d_i^T x
    return torch.sum(_softplus_neg(t)) + 0.5 * rho * torch.sum((x - v) ** 2)


def _newton_xprox(x, v, rho, d, newton_steps: int = _NEWTON_STEPS):
    """Damped Newton for argmin_x sum softplus(-(Yx)_i) + rho/2 ||x-v||^2:
    ``newton_steps`` dense Newton steps, each taking the full step when it
    descends and the half step otherwise."""
    D, ell = d["D"], d["ell"]
    I = torch.eye(D.shape[1], dtype=D.dtype, device=D.device)
    for _ in range(newton_steps):
        t = ell * (D @ x)
        sig = torch.sigmoid(-t)            # = 1 - sigmoid(t)
        grad = -(D.T @ (ell * sig)) + rho * (x - v)
        w = sig * (1.0 - sig)              # logistic curvature weights
        H = (D * w[:, None]).T @ D + rho * I
        step = cho_solve(cho_factor(H), grad)
        f0 = _prox_objective(x, v, rho, d)
        x1 = x - step
        x_half = x - 0.5 * step
        f1 = _prox_objective(x1, v, rho, d)
        x = torch.where(f1 <= f0, x1, x_half)
    return x


def _pcg_solve(matvec, b, diag, iters: int):
    """Fixed-iteration Jacobi-preconditioned CG for the SPD Newton system,
    matrix-free and without data-dependent control flow.  The tiny-guards
    make a fully converged system a no-op (r = 0 propagates zero updates)
    instead of 0/0 NaNs."""
    tiny = torch.finfo(b.dtype).tiny
    x = torch.zeros_like(b)
    r = b
    z = r / diag
    p = z
    rz = torch.sum(r * z)
    for _ in range(int(iters)):
        hp = matvec(p)
        alpha = rz / torch.clamp_min(torch.sum(p * hp), tiny)
        x = x + alpha * p
        r = r - alpha * hp
        z = r / diag
        rz_new = torch.sum(r * z)
        beta = rz_new / torch.clamp_min(rz, tiny)
        p = z + beta * p
        rz = rz_new
    return x


def _newton_cg_xprox(x, v, rho, d, newton_steps: int, cg_steps: int):
    """Matrix-free damped Newton: each step solves
    (D^T diag(w) D + rho I) s = grad by ``cg_steps`` Jacobi-PCG steps
    whose matvec is two (m, n) products; the Jacobi diagonal
    D2^T w + rho costs one more (D2 = D*D, kept at setup).  Three-level
    objective-gated damping: the full step, else the half, else the
    quarter."""
    D, ell, D2 = d["D"], d["ell"], d["D2"]
    for _ in range(newton_steps):
        t = ell * (D @ x)
        sig = torch.sigmoid(-t)
        grad = -(D.T @ (ell * sig)) + rho * (x - v)
        w = sig * (1.0 - sig)
        diag = D2.T @ w + rho

        def hv(s, w=w):
            return D.T @ (w * (D @ s)) + rho * s

        step = _pcg_solve(hv, grad, diag, cg_steps)
        f0 = _prox_objective(x, v, rho, d)
        x1 = x - step
        x2 = x - 0.5 * step
        f1 = _prox_objective(x1, v, rho, d)
        f2 = _prox_objective(x2, v, rho, d)
        x = torch.where(f1 <= f0, x1, torch.where(f2 <= f0, x2, x - 0.25 * step))
    return x


def _prox_f(x, z, u, rho, d):
    return _newton_xprox(x, z - u, rho, d)


def _dense_prox(x, z, u, rho, d, *, newton_steps):
    return _newton_xprox(x, z - u, rho, d, newton_steps)


def _cg_prox(x, z, u, rho, d, *, newton_steps, cg_steps):
    return _newton_cg_xprox(x, z - u, rho, d, newton_steps, cg_steps)


def _dense_prox_f_fn(newton_steps: int):
    """The dense x-prox honoring ``newton_steps`` (admm_tpu once ignored
    the knob on this path: its prox hardwired the default)."""
    if newton_steps == _NEWTON_STEPS:
        return _prox_f
    return functools.partial(_dense_prox, newton_steps=newton_steps)


def _cg_prox_f_fn(newton_steps: int, cg_steps: int):
    """The Newton-CG x-prox with its step counts bound."""
    return functools.partial(_cg_prox, newton_steps=newton_steps, cg_steps=cg_steps)


def _prox_g(x, z, u, rho, d):
    return soft_threshold(u + x, d["lam"] / rho)


def _obj(x, z, d):
    t = d["ell"] * (d["D"] @ x)
    return torch.sum(_softplus_neg(t)) + d["lam"] * torch.sum(torch.abs(z))


def make_prox_ops(D, ell, lam, config: ADMMConfig = ADMMConfig(), *,
                  inner: str = "newton", newton_steps: int = _NEWTON_STEPS,
                  cg_steps: int = 20):
    """Build (prox_f, prox_g, obj, data) from the tensor ``D`` (its device
    and dtype are the solve's): data carries D, the +/-1 labels ``ell`` and
    the l1 weight (labels apart, so batched one-vs-all lanes share one D).

    ``inner`` selects the x-prox: ``'newton'`` forms and solves the (n, n)
    Hessian (the accuracy reference); ``'newton_cg'`` is the matrix-free
    Jacobi-PCG Newton (``data["D2"]`` = D*D for its diagonal)."""
    if inner not in ("newton", "newton_cg"):
        raise ValueError(f"inner must be 'newton' or 'newton_cg', got {inner!r}")
    ell = torch.as_tensor(ell).to(device=D.device, dtype=D.dtype)
    data = {"D": D, "ell": ell, "lam": torch.as_tensor(lam, dtype=D.dtype, device=D.device)}
    if inner == "newton_cg":
        data["D2"] = D * D  # Jacobi diagonal stream (shared across lanes)
        return _cg_prox_f_fn(int(newton_steps), int(cg_steps)), _prox_g, _obj, data
    return _dense_prox_f_fn(int(newton_steps)), _prox_g, _obj, data


@register("logreg")
def _registry_entry(D, ell, lam, config=ADMMConfig(), device=None, **_):
    D, ell, _device = place_data(D, ell, device)
    return bind_data(*make_prox_ops(D, ell, lam, config))


@timed_solver
def logreg(D=None, ell=None, lam=0.1, config: ADMMConfig = ADMMConfig(), *,
           inner: str = "newton", newton_steps: int = _NEWTON_STEPS, cg_steps: int = 20,
           x0=None, z0=None, u0=None, device=None, **overrides) -> ADMMResults:
    """Sparse logistic regression.  ``D`` (m, n) data rows, ``ell`` (m,)
    labels in {-1, +1}, ``lam`` the l1 weight (0 disables shrinkage).

    The returned ``zopt`` is the sparse iterate, ``xopt`` the smooth one
    (they coincide at convergence).  ``inner='newton_cg'`` swaps the
    dense-Hessian Newton x-prox for the matrix-free Jacobi-PCG one.  ``D``
    and ``ell`` are numpy arrays or tensors; the solve runs in D's dtype
    on ``device``, or on D's device when D is a tensor, or on the CUDA
    device (``device.resolve_device``).  Called with no
    arguments it runs its tester's demo instance (``testers.problems``).
    """
    if D is None:
        # Zero-arg demo mode (reference solvers, e.g. lasso.m:122-129).
        from ..testers.problems import logregtest

        res, _test = logregtest(quiet=False, device=device)
        return res
    config = merge_config(config, overrides, body="heavy")
    check_data_vector(D, ell, "D", "ell")
    if not np.all(np.isin(host64(ell), (-1.0, 1.0))):
        raise ValueError("ell must be +/-1 labels")
    if not float(lam) >= 0:
        raise ValueError(f"lam must be nonnegative, got {lam}")
    D, ell, device = place_data(D, ell, device)
    prox_f, prox_g, obj, data = make_prox_ops(
        D, ell, lam, config, inner=inner, newton_steps=newton_steps, cg_steps=cg_steps)
    n = D.shape[1]
    return admm(
        prox_f, prox_g, config,
        A=1.0, B=-1.0, c=0.0, m=n, nA=n, nB=n,
        x0=x0, z0=z0, u0=u0,
        hooks=Hooks(obj=obj), dtype=D.dtype, data=data, device=device,
    )
