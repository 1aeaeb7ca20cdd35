"""Exchange ADMM: N agents trading a shared resource vector (port of
``admm_tpu/parallel/exchange.py``).

    min   sum_i f_i(x_i)    s.t.    sum_i x_i = 0

(Boyd et al. 2011, section 7.3.2.)  With g = indicator{sum z_i = 0} the
z-update is the projection z_i = x_i + u_i - mean(x + u); under equal
dual initialization all u_i collapse to ONE shared price vector u, and
the iteration reduces to

    x_i <- prox_{f_i/rho}( x_i - x̄ - u )      (all agents, local)
    x̄  <- mean_i x_i                           (the one mean over agents)
    u   <- u + x̄                               (replicated, O(n))

Residuals on the underlying splitting (A = I, B = -I, z_i = x_i - x̄):
pnorm = sqrt(W)||x̄||, s_i = -rho ((x_i - x̄) - (x_i^prev - x̄^prev)).  At a
fixed point rho*u is (minus) the market-clearing price.

Variants as ``admm_tpu`` runs them: relaxation (the dual collapse
survives it: u <- u + mean(x̂), the mean-free z stack carried), fast and
accelerated momentum on the stack (v in the mean-free z-space, uhat ONE
price vector; the d-value tiles the price W ways:
d = (W/rho)||u - uhat||^2 + rho||z - v||_F^2), Anderson acceleration on
(z stack, price) (``anderson.py``), residual-balancing rho on the plain
iteration and the stall window.  No H-norm stop and no adaptive rho, as
in ``admm_tpu``.  The lean alg-0/relax-1 path keeps z implicit.

The W agents are dim 0 of (W, n) tensors on one device (``mesh.Mesh``),
or each rank's block of them over a process group; the loop is
``engine.run_steps``.  A step issues two collectives through the mesh: the
mean over the agents (n floats; with relaxation the relaxed mean rides in
the same call), and the agents' sums of the residual norms (three
scalars, one more under relaxation and one for the alg-2 d-value).  The
stacked allocations come back whole through one ``all_gather``.
"""

from __future__ import annotations

import math
import time
from typing import Callable, Optional

import torch

from ..anderson import AndersonWindow
from ..config import ADMMConfig, matmul_precision, resolve_unroll
from ..engine import (fast_update, fro, fro2, history, residual_balance_factor, run_steps, sync,
                      traces)
from ..models._common import as_tensor
from ..results import ADMMResults
from .consensus import _data_dtype, _on_device
from .mesh import Mesh, resolve_mesh, shard_count


def _names(cfg):
    return (["pnorm", "dnorm", "perr", "derr"] + (["dvals"] if cfg.alg == 2 else [])
            + (["avals"] if cfg.alg else []))


def _needs_z(cfg):
    """Whether the mean-free z stack is carried (relaxation, momentum and
    AA need it; the lean path derives z_i = x_i - x̄)."""
    return cfg.relax != 1.0 or bool(cfg.alg) or cfg.anderson > 0


def _make_exchange_step(local_prox, cfg: ADMMConfig, W: int, n: int, window, mesh: Mesh):
    """One exchange iteration (``admm_tpu``'s ``_make_exchange_run`` step)
    as the ``(xupdate, tail)`` pair of ``engine.run_steps``; ``W`` is the
    global agent count and ``mesh`` reduces over the agents."""
    alg = cfg.alg
    relax = float(cfg.relax)
    use_relax = relax != 1.0
    needs_z = _needs_z(cfg)
    std_stop = cfg.stopcond in ("standard", "both")
    use_stall = cfg.use_stall
    sqW, sqWn = math.sqrt(float(W)), math.sqrt(float(W * n))

    def xupdate(c, data):
        # The agents' proxes, and the z stack they start from (the lean
        # path derives it).
        zprev = c["z"] if needs_z else c["xi"] - c["xbar"][None, :]
        if alg == 0:
            return local_prox(zprev - c["u"][None, :], c["rho"], data), zprev
        return local_prox(c["v"] - c["uhat"][None, :], c["rho"], data), zprev

    def tail(c, bufs, data, x, frozen, slot, put):
        xi_new, zprev = x
        rho = c["rho"]
        no = torch.zeros_like(c["done"])
        k = c["k"]
        i = k + 1
        u = c["u"]
        if alg == 0:
            u_base = u
        else:
            u_prev, uhat = u, c["uhat"]
            u_base = uhat
        if use_relax:
            xhat = relax * xi_new + (1.0 - relax) * zprev
            xbar_new, xhat_bar = mesh.pmean(xi_new, xhat)
            z_new = xhat - xhat_bar[None, :]
            u_new = u_base + xhat_bar
        else:
            xbar_new = mesh.pmean(xi_new)
            z_new = xi_new - xbar_new[None, :]
            u_new = u_base + xbar_new

        new = {}
        if alg == 1:
            v_new, uhat_new, a_new, _, _ = fast_update(
                alg, cfg, aprev=c["a"], dprev=None, z=z_new, zprev=zprev, u=u_new,
                uprev=u_prev, v=c["v"])
            new.update(v=v_new, uhat=uhat_new, a=a_new)

        # The agents' sums of the norms in one collective.
        parts = [fro2(z_new - (v_new if alg == 1 else zprev)), fro2(xi_new), fro2(z_new)]
        if use_relax:
            parts.append(fro2(xi_new - z_new))  # the UNRELAXED x, as the engine
        if alg == 2:
            parts.append(torch.sum((z_new - c["v"]) ** 2))
        sums = mesh.psum(*parts)
        pnorm = torch.sqrt(sums[3]) if use_relax else sqW * fro(xbar_new)

        if alg == 2:
            dval = (float(W) / rho) * torch.sum((u_new - uhat) ** 2) + rho * sums[-1]
            v_new, uhat_new, a_new, d_new, restarted_i = fast_update(
                alg, cfg, aprev=c["a"], dprev=c.get("d"), z=z_new, zprev=zprev, u=u_new,
                uprev=u_prev, v=c["v"], dval=dval)
            new.update(v=v_new, uhat=uhat_new, a=a_new, d=d_new)

        dnorm = rho * torch.sqrt(sums[0])
        perr = sqWn * cfg.abstol + cfg.reltol * torch.maximum(torch.sqrt(sums[1]),
                                                              torch.sqrt(sums[2]))
        derr = sqWn * cfg.abstol + cfg.reltol * rho * sqW * fro(u_new)

        diverged_i = ~torch.isfinite(pnorm) if cfg.nanguard else no
        stall_i = no
        if use_stall:
            improved = pnorm < c["best_p"] * (1.0 - cfg.stalltol)
            since_new = torch.where(improved, 0, c["since"] + 1)
            new.update(best_p=torch.minimum(c["best_p"], pnorm), since=since_new)
            stall_i = since_new >= cfg.stallwindow

        stop = no
        if alg == 2:
            stop = (i >= 2) & (torch.abs(d_new - c["d"]) <= cfg.dvaltol * c["d"])
        elif std_stop and not cfg.domaxiters:
            stop = pnorm < perr
            if not cfg.nodualerror:
                stop = stop & (dnorm < derr)
        done = stop | diverged_i | stall_i

        rho_new = rho
        if cfg.rbadaptive and alg == 0:
            factor = residual_balance_factor(cfg, pnorm=pnorm, dnorm=dnorm, done=done,
                                             dtype=rho.dtype)
            rho_new = rho * factor
            u_new = u_new / factor

        z_next, u_next = z_new, u_new
        if window is not None:
            (z_next, u_next), acnt, abest, bufs["aF"], bufs["aT"] = window.step(
                [zprev, c["u"]], [z_new, u_new], c["acnt"], c["abest"], bufs["aF"],
                bufs["aT"], done=done, frozen=frozen, put=put)
            new.update(acnt=acnt, abest=abest)

        vals = ([pnorm, dnorm, perr, derr] + ([d_new] if alg == 2 else [])
                + ([a_new] if alg else []))
        bufs["hist"] = put(bufs["hist"], 1, slot, torch.stack(vals).reshape(-1, 1))
        if alg == 2:
            bufs["restarted"] = put(bufs["restarted"], 0, slot, restarted_i.reshape(1))
        if cfg.record_iterates:
            bufs["xvals"] = put(bufs["xvals"], 0, slot, xbar_new.unsqueeze(0))
            bufs["uvals"] = put(bufs["uvals"], 0, slot, u_new.unsqueeze(0))

        new.update(k=k + 1, xi=xi_new, u=u_next, xbar=xbar_new, rho=rho_new, done=done,
                   diverged=c["diverged"] | diverged_i, stalled=c["stalled"] | stall_i)
        if needs_z:
            new["z"] = z_next
        return new, bufs

    return xupdate, tail


def _exchange_solve(local_prox, cfg: ADMMConfig, W: int, n: int, data, xi0, u0,
                    mesh: Mesh) -> dict:
    """Run the exchange iteration from the whole (W, n) ``xi0`` and the
    price ``u0``; over ``mesh``'s process group the agents' state (and
    ``data``) is this rank's block, the results whole."""
    rdtype, device = xi0.dtype, xi0.device
    N, alg = int(cfg.maxiters), cfg.alg
    full = lambda v: torch.full((), v, dtype=rdtype, device=device)  # noqa: E731
    false = torch.zeros((), dtype=torch.bool, device=device)
    names = _names(cfg)
    xbar0 = torch.mean(xi0, dim=0)
    xi0 = mesh.take(xi0)
    z0 = xi0 - xbar0[None, :]
    window = (AndersonWindow(cfg, [xi0.shape[0] * n, n], dtype=rdtype, device=device,
                             sharded=[True, False], psum=mesh.psum)
              if cfg.anderson > 0 else None)
    s = {"k": torch.zeros((), dtype=torch.int64, device=device), "xi": xi0, "u": u0,
         "xbar": xbar0, "rho": full(cfg.rho), "done": false, "diverged": false,
         "stalled": false}
    if _needs_z(cfg):
        s["z"] = z0
    if alg:
        s.update(v=z0, uhat=u0, a=full(1.0))
        if alg == 2:
            s["d"] = full(float("inf"))
    if cfg.use_stall:
        s.update(best_p=full(float("inf")),
                 since=torch.zeros((), dtype=torch.int64, device=device))
    bufs = {"hist": history(names, N, (), rdtype, device)}
    if alg == 2:
        bufs["restarted"] = torch.zeros(N + 1, dtype=torch.int32, device=device)
    if cfg.record_iterates:
        for name in ("xvals", "uvals"):
            bufs[name] = torch.zeros((N + 1, n), dtype=rdtype, device=device)
    if window is not None:
        bufs["aF"], bufs["aT"] = window.rings()
        s["acnt"], s["abest"] = window.initial()

    xupdate, tail = _make_exchange_step(local_prox, cfg, W, n, window, mesh)
    with matmul_precision(cfg.matmul_precision):
        s, bufs = run_steps(xupdate, tail, s, bufs, data, N, int(cfg.unroll))
    if _needs_z(cfg):
        xi, z = mesh.gather(s["xi"], s["z"])
    else:
        xi = mesh.gather(s["xi"])
        z = xi - s["xbar"][None, :]
    return {"steps": s["k"], "xopt": xi, "zopt": z,
            "uopt": s["u"], "xbar": s["xbar"], "rho_final": s["rho"],
            "diverged": s["diverged"], "stalled": s["stalled"], "hist": traces(names, bufs, N)}


def exchange_admm(
    local_prox: Callable,
    data,
    n: int,
    config: ADMMConfig = ADMMConfig(),
    *,
    mesh: Optional[Mesh] = None,
    nagents: Optional[int] = None,
    xi0=None,
    u0=None,
    device=None,
) -> ADMMResults:
    """Generic exchange ADMM over ``nagents`` agents (default: the mesh
    size).

    ``local_prox(vi, rho, data) -> xi`` evaluates ALL agents' proxes
    prox_{f_i/rho}(v_i) at once on a stacked (W, n) tensor, with
    per-agent operands carried in ``data`` as (W, ...) values.  ``xi0``
    (W, n) and ``u0`` (n,) warm-start the allocations and the price.
    Results: ``xopt`` the stacked allocations, ``uopt`` the shared price
    (rho * uopt estimates the clearing price), ``extra['xbar']`` the
    residual mean.  Placement and dtype as in ``consensus_admm``; over a
    process group ``data``'s per-agent leaves hold this rank's block.
    """
    mesh, device = resolve_mesh(mesh, device, data)
    W = nagents if nagents is not None else mesh.size
    data = _on_device(data, device)
    rdtype = _data_dtype(data)

    def init(v, shape):
        if v is None:
            return torch.zeros(shape, dtype=rdtype, device=device)
        return as_tensor(v).to(device=device, dtype=rdtype)

    xi0, u0 = init(xi0, (W, n)), init(u0, (n,))
    if tuple(xi0.shape) != (W, n):
        raise ValueError(f"xi0 must have shape {(W, n)}; got {tuple(xi0.shape)}")
    if tuple(u0.shape) != (n,):
        raise ValueError(f"u0 must have shape {(n,)}; got {tuple(u0.shape)}")
    config = resolve_unroll(config, "gemv")

    sync(device)
    t0 = time.perf_counter()
    out = _exchange_solve(local_prox, config, W, n, data, xi0, u0, mesh)
    sync(device)
    runtime = time.perf_counter() - t0
    res = ADMMResults.from_raw({k: v for k, v in out.items() if k != "xbar"}, config)
    res.runtime = runtime
    res.extra.update(xbar=out["xbar"], nagents=W, mesh=mesh)
    return res


# ---- quadratic-agents instantiation ---------------------------------------


def _quad_local_prox(vi, rho, d):
    # prox of f_i = 0.5||A_i x - b_i||^2 through the per-agent eigh
    # (valid for any rho: no refactorization in the loop).
    rhs = d["Atb"] + rho * vi
    y = torch.einsum("wji,wj->wi", d["V"], rhs) / (d["w"] + rho)
    return torch.einsum("wij,wj->wi", d["V"], y)


def quad_setup(As, bs):
    """Per-agent Gram eigendecomposition and A_i^T b_i, at full precision."""
    with matmul_precision("highest"):
        G = torch.einsum("wmi,wmj->wij", As, As)
        w, V = torch.linalg.eigh(G)
        return {"w": w, "V": V, "Atb": torch.einsum("wmi,wm->wi", As, bs)}


def exchange_quadratic(
    As,
    bs,
    config: ADMMConfig = ADMMConfig(),
    *,
    mesh: Optional[Mesh] = None,
    xi0=None,
    u0=None,
    device=None,
) -> ADMMResults:
    """Exchange ADMM with quadratic agents f_i(x) = 0.5||A_i x - b_i||^2.

    ``As`` is a (W, m, n) stack and ``bs`` (W, m); W agents need a mesh of
    W shards, or fewer (a multiple; fewer agents than the mesh take a
    sub-mesh).  The market equilibrium has the closed form
    x_i* = (A_i^T A_i)^{-1}(A_i^T b_i - nu*) with the clearing price
    nu* = (sum_i (A_i^T A_i)^{-1})^{-1} sum_i (A_i^T A_i)^{-1} A_i^T b_i.
    Placement as in ``consensus_lasso``.
    """
    mesh, device = resolve_mesh(mesh, device, As, bs)
    As = as_tensor(As).to(device)
    bs = as_tensor(bs).to(device=device, dtype=As.dtype)
    if As.ndim != 3:
        raise ValueError(f"As must be (W, m, n), got {tuple(As.shape)}")
    if tuple(bs.shape) != tuple(As.shape[:2]):
        raise ValueError(f"bs must be {tuple(As.shape[:2])}, got {tuple(bs.shape)}")
    W, _, n = As.shape
    W, mesh = shard_count(mesh, W)
    return exchange_admm(_quad_local_prox, quad_setup(mesh.take(As), mesh.take(bs)), n, config,
                         mesh=mesh, nagents=W, xi0=xi0, u0=u0)
