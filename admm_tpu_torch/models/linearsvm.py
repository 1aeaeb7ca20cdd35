"""Linear SVM via unwrapped ADMM with transpose reduction (port of the
serial path of ``admm_tpu/models/linearsvm.py``):

    min 1/2 ||x||^2 + C * loss(ell .* (D x))

with hinge loss sum(max(1 - v, 0)) or (nonconvex) 0-1 loss
sum(max(sign(1 - v), 0)).

Reference: solvers/linearsvm.m (wrapper; objective at linearsvm.m:231-237;
delegation to unwrappedadmm at :242) and getProxOps.m case 'linearsvm'
(:202-310) with z-proxes zminLinearSVM (getProxOps.m:1084-1103) and the
0-1 prox minz01 (getProxOps.m:1158-1180).

z lives in data space (one entry per sample): z_i ~ ell_i * margin_i.

z-update (hinge): z = (Dx + u) + ell .* max(min(1 - v, C/rho), 0),
                  v = ell .* (Dx + u)
z-update (0-1):   z = ell .* y,  y_i = s_i where s_i >= 1 or
                  s_i < 1 - sqrt(2 C / rho), else 1  (s = v)

The distributed variant (row-sharded D, the reference's parfor path)
comes with slice 10 of ROADMAP.md queue 1; ``parallel=True`` raises.
"""

from __future__ import annotations

import torch

from ..config import ADMMConfig
from ..ops.prox import hinge_prox, zero_one_prox
from ..results import ADMMResults
from . import register
from ._common import bind_data, check_data_vector, merge_config, place_data, timed_solver
from .unwrapped import unwrappedadmm


def _prox_g_hinge(x, z, u, rho, d):
    return hinge_prox(d["D"] @ x + u, d["ell"], d["C"], rho)


def _prox_g_01(x, z, u, rho, d):
    return zero_one_prox(d["D"] @ x + u, d["ell"], d["C"], rho)


def _prox_g_hinge_relaxed(Axhat, z, u, rho, d):
    # Under relaxation the engine hands Axhat, already in D-space
    # (the reference's zminLinearSVM would wrongly re-apply D here).
    return hinge_prox(Axhat + u, d["ell"], d["C"], rho)


def _prox_g_01_relaxed(Axhat, z, u, rho, d):
    return zero_one_prox(Axhat + u, d["ell"], d["C"], rho)


def _obj_hinge(x, z, d):
    v = d["ell"] * (d["D"] @ x)
    return 0.5 * torch.sum(x * x) + d["C"] * torch.sum(torch.clamp_min(1.0 - v, 0.0))


def _obj_01(x, z, d):
    v = d["ell"] * (d["D"] @ x)
    return 0.5 * torch.sum(x * x) + d["C"] * torch.sum(
        torch.clamp_min(torch.sign(1.0 - v), 0.0)
    )


def _is_01(loss: str) -> bool:
    return str(loss).replace("-", "") in ("01", "zeroone")


def make_prox_ops(D, ell, C, loss: str = "hinge", config: ADMMConfig = ADMMConfig()):
    """Build (prox_f, prox_g, obj, data) for the linear SVM
    (getProxOps.m:202-310) from D, a tensor on the solve's device.
    prox_f is None: the x-update belongs to the unwrapped-ADMM solver
    (linearsvm.m:242).  Relaxation selects the Axhat-consuming prox
    variant (the engine hands A x already applied)."""
    relaxed = config.relax != 1.0
    as_d = lambda v: torch.as_tensor(v, dtype=D.dtype, device=D.device)  # noqa: E731
    data = {"D": D, "ell": as_d(ell), "C": as_d(C)}
    if _is_01(loss):
        return None, (_prox_g_01_relaxed if relaxed else _prox_g_01), _obj_01, data
    return None, (_prox_g_hinge_relaxed if relaxed else _prox_g_hinge), _obj_hinge, data


@register("linearsvm")
def _registry_entry(D, ell, C, loss="hinge", config=ADMMConfig(), device=None, **_):
    D, ell, _device = place_data(D, ell, device)
    return bind_data(*make_prox_ops(D, ell, C, loss, config))


@timed_solver
def linearsvm(
    D=None, ell=None, C=None, config: ADMMConfig = ADMMConfig(), *,
    loss: str = "hinge", seed: int = 0, x0=None, z0=None, u0=None,
    parallel=False, nshards=None, mesh=None, device=None,
    **overrides,
) -> ADMMResults:
    """Train a linear SVM (reference solvers/linearsvm.m:92).

    Delegates to unwrappedadmm(minz, D, ...) exactly as the reference does
    (linearsvm.m:242), which forces stopcond='both': ``anderson=`` is
    refused there, as in ``admm_tpu``.  ``D``, ``ell`` and ``device`` work
    as ``D``, ``s`` and ``device`` of ``lasso``; the random start is
    ``unwrapped.random_start``'s.  ``parallel=True`` (with ``nshards`` and
    ``mesh``; slice 10) and the zero-argument demo mode (slice 11) are not
    ported yet and raise ``NotImplementedError``.
    """
    if D is None:
        raise NotImplementedError(
            "linearsvm() demo mode needs the testers of ROADMAP.md queue 1, "
            "slice 11, which are not ported yet")
    check_data_vector(D, ell, sname="ell")
    config = merge_config(config, overrides, body="gemv")
    if parallel:
        raise NotImplementedError(
            "linearsvm(parallel=True) needs the transpose-reduction runner of "
            "ROADMAP.md queue 1, slice 10, which is not ported yet")
    D, ell, device = place_data(D, ell, device)
    _, prox_g, obj, data = make_prox_ops(D, ell, C, loss, config)
    return unwrappedadmm(prox_g, D, config, obj=obj, seed=seed, data=data,
                         x0=x0, z0=z0, u0=u0, device=device)
