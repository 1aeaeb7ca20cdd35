"""Consensus (global-variable) ADMM over W stacked shards (port of
``admm_tpu/parallel/consensus.py``).

The reference's parallel LASSO (getProxOps.m:367-442 setup;
xminParallelLASSO :1217-1260; zminParallelLASSO :1272-1299; altuLASSO
:1312-1326; lassonorms :1335-1343) shards data rows into N slices, gives
each worker a local x_i/u_i, and keeps a single global z:

    x_i <- local_prox(z - u_i)                                  [local]
    xbar = mean_i x_i,  ubar = mean_i u_i                       [mean over dim 0]
    z    <- global_prox(xbar + ubar)                            [replicated]
    u_i  <- u_i + x_i - z                                       [local]

with consensus residuals stored *squared*, as the reference's lassonorms
feeds them to its engine:

    pnorm = sum_i ||x_i - xbar||^2
    dnorm = N rho^2 ||xbar - xbar_prev||^2

and Boyd errors computed from the consensus aggregates.

DELIBERATE reference parity quirk (``admm_tpu``'s, kept): the stopping
test compares these SQUARED residuals against the LINEAR Boyd tolerances
perr/derr, so a consensus solve stops at a residual around
sqrt(tolerance).  The rbadaptive balancing rule unsquares them before it
compares, so rbmu keeps its engine meaning.

Every variant of ``admm_tpu``'s consensus runner is here: relaxation
(x̂_i = relax x_i + (1 - relax) z_prev, an extension beyond the reference,
whose consensus path ignores options.relax), the H-norm stops and the
``convtest`` monitor over the aggregates w = [xbar; z; rho ubar],
adaptive and residual-balancing rho (dynamic-rho local solves through a
batched eigh), fast weak and strong momentum on the stacked splitting,
Anderson acceleration over (z, {u_i}) (``anderson.py``, two leaves), the
stall window, iterate records of the aggregates, NaN flags and the
xi0/ui0/z0 warm start.

Layout: ``admm_tpu`` places the stacked (W, ...) arrays over a device
mesh with GSPMD and its means compile to all-reduces.  Here the W shards
are dim 0 of tensors on one device (``mesh.Mesh``), or, over a process
group, each rank's block of W/P shards on its own device.  Every
reduction over the shard axis goes through the mesh (``Mesh.pmean``,
``Mesh.psum``), at the same place in the update; a step issues two
(``xbar`` with ``ubar``: 2n floats; the residual scalars, with the alg-2
d-value's part), and Anderson acceleration two more.  The per-shard
results ``xi``/``ui`` come back whole on every rank through one
``all_gather`` (``Mesh.gather``).  The lanes x shards batches take the
2-D mesh's layout (``Mesh.lane_layout``): with the ranks dividing the
lanes each rank stacks every shard of its lanes and its steps issue no
collective; with a lane row over several ranks each holds its block of
the row's shards, the means and sums run over the row's subgroup (one
collective for all the row's lanes under vmap), and each chunk's flags
over the whole group.  The loop is ``engine.run_steps``: chunks
of K sub-steps, one host read a chunk; over ranks every rank reads the
same ``(k, done)``, which comes only from reduced values.  A per-shard
local solve is a batched GEMV (``torch.einsum`` over the (W, n, n)
stack).
"""

from __future__ import annotations

import functools
import math
import time
from typing import Callable, Optional

import torch

from ..anderson import AndersonWindow
from ..config import ADMMConfig, matmul_precision, resolve_unroll
from ..engine import (adaptive_rho_update, fast_update, fro2, history, residual_balance_factor,
                      run_steps, sync, traces)
from ..models._common import as_tensor
from ..models.logreg import _softplus_neg
from ..ops.matfun import covsel_ns_prox
from ..ops.prox import covsel_eig_prox, soft_threshold
from ..ops.solve import cho_factor, cho_solve
from ..results import ADMMResults
from ..utils.profiling import span
from ._loop import gather_lanes
from .mesh import Mesh, lane_shard_count, pad_rows, resolve_mesh, shard_count, shard_rows


def _consensus_names(cfg):
    return (["pnorm", "dnorm", "perr", "derr"] + (["Hnormsq"] if cfg.needs_hnorm else [])
            + (["dvals"] if cfg.alg == 2 else []) + (["avals"] if cfg.alg else []))


def _make_consensus_step(local_prox, global_prox, cfg: ADMMConfig, W: int, n: int, window,
                         mesh: Mesh):
    """One consensus iteration (``admm_tpu``'s ``_make_consensus_run``
    step) as the ``(xupdate, tail)`` pair of ``engine.run_steps``; ``W``
    is the global shard count and ``mesh`` reduces over the shard axis."""
    alg = cfg.alg
    relax = float(cfg.relax)
    use_relax = relax != 1.0
    needs_h = cfg.needs_hnorm
    std_stop = cfg.stopcond in ("standard", "both")
    h_stop = cfg.stopcond in ("hnorm", "both")
    use_adaptive = cfg.adaptive and cfg.convtest and needs_h
    use_stall = cfg.use_stall
    sqn = math.sqrt(float(n))

    def xupdate(c, data):
        # Local x-solves on the stacked (W, n) state; fast modes pull back
        # the predictors v/uhat (engine x = pf(x, v, uhat, rho)).
        if alg == 0:
            return local_prox(c["z"], c["ui"], c["rho"], data)
        return local_prox(c["v"], c["uhat"], c["rho"], data)

    def tail(c, bufs, data, xi, frozen, slot, put):
        """The rest of the step after the local solves ``xi``."""
        rho = c["rho"]
        rdtype = rho.dtype
        eps = torch.finfo(rdtype).eps
        rho0 = torch.full_like(rho, cfg.rho)  # setup-time rho captured inside H
        no = torch.zeros_like(c["done"])
        i = c["k"] + 1  # the reference's 1-based counter
        zprev = c["z"]
        if alg == 0:
            u_base = c["ui"]
        else:
            ui_prev, uhat = c["ui"], c["uhat"]
            u_base = uhat

        # Over-relaxation on the per-slice constraint x_i - z = 0.
        xhat = relax * xi + (1.0 - relax) * zprev[None, :] if use_relax else xi
        # Consensus aggregates: the means over the shard axis (one
        # collective of 2n floats).
        xbar, ubar_base = mesh.pmean(xi, u_base)
        xhat_bar = relax * xbar + (1.0 - relax) * zprev if use_relax else xbar
        z = global_prox(xhat_bar, ubar_base, rho, W, data)
        ui = u_base + (xhat - z[None, :])
        ubar = ubar_base + (xhat_bar - z)  # post-update dual average (derr)

        # The shard-axis sums of the residual (and the alg-2 d-value's
        # dual part) in one collective.
        pnorm = fro2(xi - xbar[None, :])
        if alg == 2:
            pnorm, du = mesh.psum(pnorm, fro2(ui - uhat))
        else:
            pnorm = mesh.psum(pnorm)

        new = {}
        if alg:
            # d on the stacked problem: B tiles z over W slices.
            dval = ((1.0 / rho) * du + rho * W * fro2(z - c["v"])
                    if alg == 2 else None)
            v_new, uhat_new, a_new, d_new, restarted_i = fast_update(
                alg, cfg, aprev=c["a"], dprev=c.get("d"), z=z, zprev=zprev, u=ui,
                uprev=ui_prev, v=c["v"], dval=dval)
            new.update(v=v_new, uhat=uhat_new, a=a_new)
            if alg == 2:
                new["d"] = d_new

        dnorm = W * rho**2 * fro2(xbar - c["xbar_prev"])
        perr = sqn * cfg.abstol + cfg.reltol * torch.maximum(torch.sqrt(fro2(xbar)),
                                                              torch.sqrt(fro2(z)))
        derr = sqn * cfg.abstol + cfg.reltol * rho * torch.sqrt(fro2(ubar))

        diverged_i = ~torch.isfinite(pnorm) if cfg.nanguard else no
        if needs_h:
            wu_new = rho * ubar
            Hsq = rho0 * fro2(zprev - z) + rho0 * fro2(c["wu_prev"] - wu_new)
            if cfg.convtest and alg == 0:
                H1 = c["Hprev"]
                diverged_i = diverged_i | ((i >= 2) & (H1 > eps) & (Hsq > H1)
                                           & ((Hsq - H1) > H1 * cfg.convtol))
            new.update(wu_prev=wu_new, Hprev=Hsq)

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
        if h_stop and not cfg.domaxiters and needs_h:
            stop = stop | ((i > 2) & (Hsq <= cfg.hnormtol))
        done = stop | diverged_i | stall_i

        rho_new = rho
        if use_adaptive:
            rho_new = adaptive_rho_update(cfg, Hprev=c["Hprev"], Hsq=Hsq, rho=rho, i=i,
                                          done=done, eps=eps)
        elif cfg.rbadaptive and alg == 0:
            # pnorm/dnorm are squared; the balancing rule compares norms.
            factor = residual_balance_factor(cfg, pnorm=torch.sqrt(pnorm),
                                             dnorm=torch.sqrt(dnorm), done=done, dtype=rdtype)
            rho_new = rho * factor
            ui = ui / factor
            ubar = ubar / factor

        # Anderson acceleration on (z, {u_i}): the candidate replaces the
        # next sweep's start only; residuals and history stay the plain
        # sweep's.
        z_next, ui_next = z, ui
        if window is not None:
            (z_next, ui_next), acnt, abest, bufs["aF"], bufs["aT"] = window.step(
                [zprev, c["ui"]], [z, ui], c["acnt"], c["abest"], bufs["aF"], bufs["aT"],
                done=done, frozen=frozen, put=put)
            new.update(acnt=acnt, abest=abest)

        vals = ([pnorm, dnorm, perr, derr] + ([Hsq] if needs_h else [])
                + ([d_new] if alg == 2 else []) + ([a_new] if alg else []))
        bufs["hist"] = put(bufs["hist"], 1, slot, torch.stack(vals).reshape(-1, 1))
        if alg == 2:
            bufs["restarted"] = put(bufs["restarted"], 0, slot, restarted_i.reshape(1))
        if cfg.record_iterates:
            rows = {"xvals": xbar, "zvals": z, "uvals": ubar,
                    "wvals": torch.cat((xbar, z, (rho_new if cfg.rbadaptive else rho) * ubar))}
            if alg:
                rows["vvals"] = v_new
            for name, val in rows.items():
                bufs[name] = put(bufs[name], 0, slot, val.unsqueeze(0))

        new.update(k=c["k"] + 1, xi=xi, z=z_next, ui=ui_next, xbar_prev=xbar, rho=rho_new,
                   done=done, diverged=c["diverged"] | diverged_i,
                   stalled=c["stalled"] | stall_i)
        return new, bufs

    return xupdate, tail


def _consensus_solve(local_prox, global_prox, cfg: ADMMConfig, W: int, n: int, data,
                     xi0, ui0, z0, data_dims=None, mesh: Optional[Mesh] = None,
                     local_state: bool = False, agree=None) -> dict:
    """Run the consensus iteration from (xi0, ui0, z0), the whole (W, n)
    stacks; returns the raw result dict.  Over ``mesh``'s process group
    the state is this rank's block of shards (``data``'s shard-axis leaves
    are that block) and ``xi``/``ui`` come back whole; with
    ``local_state`` xi0/ui0 are this rank's block already and the results
    stay so.  With ``data_dims`` the state carries a leading lane axis
    (``engine.run_steps``) and ``mesh`` takes its block of shards on dim 1
    (lanes whose shards span ranks: ``agree``, as in ``run_steps``)."""
    mesh = Mesh((W,), ("shards",), z0.device) if mesh is None else mesh
    lead = tuple(z0.shape[:-1])
    rdtype, device = z0.dtype, z0.device
    N, alg = int(cfg.maxiters), cfg.alg
    full = lambda v: torch.full(lead, v, dtype=rdtype, device=device)  # noqa: E731
    zeros = lambda *shape: torch.zeros(lead + shape, dtype=rdtype, device=device)  # noqa: E731
    false = torch.zeros(lead, dtype=torch.bool, device=device)
    names = _consensus_names(cfg)
    if local_state:
        pmean = mesh.pmean if data_dims is None else torch.func.vmap(mesh.pmean)
        xbar0, ubar0 = pmean(xi0, ui0)
    else:
        xbar0, ubar0 = torch.mean(xi0, dim=-2), torch.mean(ui0, dim=-2)
        xi0, ui0 = mesh.take(xi0, dim=-2), mesh.take(ui0, dim=-2)
    wu0 = cfg.rho * ubar0
    window = (AndersonWindow(cfg, [n, xi0.shape[-2] * n], dtype=rdtype, device=device,
                             sharded=[False, True], psum=mesh.psum)
              if cfg.anderson > 0 else None)

    s = {"k": torch.zeros(lead, dtype=torch.int64, device=device), "xi": xi0, "z": z0,
         "ui": ui0, "xbar_prev": xbar0, "rho": full(cfg.rho),
         "done": false, "diverged": false, "stalled": false}
    if alg:
        s.update(v=z0, uhat=ui0, a=full(1.0))
        if alg == 2:
            s["d"] = full(float("inf"))
    if cfg.needs_hnorm:
        s.update(wu_prev=wu0, Hprev=full(float("inf")))
    if cfg.use_stall:
        s.update(best_p=full(float("inf")), since=torch.zeros(lead, dtype=torch.int64,
                                                              device=device))
    bufs = {"hist": history(names, N, lead, rdtype, device)}
    if alg == 2:
        bufs["restarted"] = torch.zeros(lead + (N + 1,), dtype=torch.int32, device=device)
    if cfg.record_iterates:
        for name in ("xvals", "zvals", "uvals") + (("vvals",) if alg else ()):
            bufs[name] = zeros(N + 1, n)
        bufs["wvals"] = zeros(N + 1, 3 * n)
    if window is not None:
        bufs["aF"], bufs["aT"] = window.rings(lead)
        s["acnt"], s["abest"] = window.initial(lead)

    xupdate, tail = _make_consensus_step(local_prox, global_prox, cfg, W, n, window, mesh)
    with matmul_precision(cfg.matmul_precision):
        s, bufs = run_steps(xupdate, tail, s, bufs, data, N, int(cfg.unroll),
                            data_dims=data_dims, agree=agree)
    xi, ui = s["xi"], s["ui"]
    if data_dims is None and not local_state:
        xi, ui = mesh.gather(xi, ui)
    return {"steps": s["k"], "xopt": torch.mean(xi, dim=-2), "zopt": s["z"],
            "uopt": torch.mean(ui, dim=-2), "xi": xi, "ui": ui,
            "rho_final": s["rho"], "diverged": s["diverged"], "stalled": s["stalled"],
            "hist": traces(names, bufs, N, lanes=data_dims is not None)}


def _on_device(data, device):
    """``data``'s values as tensors on ``device`` (numpy arrays and numbers
    converted, tensors moved)."""
    return {k: as_tensor(v).to(device) for k, v in data.items()}


def _data_dtype(data):
    """The dtype of ``data``'s first tensor in sorted key order (the order
    ``jax.tree_util`` flattens a dict in), or float32."""
    for key in sorted(data):
        return data[key].dtype
    return torch.float32


def consensus_admm(
    local_prox: Callable,
    global_prox: Callable,
    data,
    n: int,
    config: ADMMConfig = ADMMConfig(),
    *,
    mesh: Optional[Mesh] = None,
    nshards: Optional[int] = None,
    xi0=None,
    ui0=None,
    z0=None,
    body: str = "gemv",
    device=None,
) -> ADMMResults:
    """Generic consensus ADMM.

    ``local_prox(z, ui, rho, data) -> xi`` computes ALL per-shard local
    solves at once on stacked (W, n) tensors; ``global_prox(xbar, ubar,
    rho, W, data) -> z`` is the global update (under relaxation its first
    argument is the relaxed aggregate x̂bar).  ``data`` is a dict of
    operands (tensors, numpy arrays or numbers; those with a leading shard
    axis stacked W ways).

    The solve runs on ``device``, else the mesh's, else that of the first
    tensor in ``data``, else the CUDA device (``mesh.resolve_mesh``), in
    the dtype of ``data``'s first value in sorted key order.  ``nshards``
    defaults to the mesh size.  ``xi0``/``ui0`` (shape (W, n)) and ``z0``
    (shape (n,)) warm-start the consensus state; pass the xi/ui of a
    previous solve's ``results.extra`` to resume.  The wall clock
    (``results.runtime``) stops before the results are read back.

    Over a mesh with a process group (``multihost.global_mesh``) each
    rank runs its contiguous block of W/P shards: ``data``'s shard-axis
    leaves hold that block (``Mesh.take`` cuts it from the whole stack),
    ``xi0``/``ui0`` stay whole, and every rank gets the whole results.

    Spans (``utils.profiling.span``): ``admm_tpu_torch.prepare`` up to the
    device sync that opens the loop, the loop's own
    (``engine.run_steps``; each sub-step's local solves in
    ``step.xupdate``, the rest and its freeze select in ``step.tail``) and
    ``admm_tpu_torch.result`` around the result's assembly.
    """
    with span("admm_tpu_torch.prepare"):
        mesh, device = resolve_mesh(mesh, device, data)
        W = nshards if nshards is not None else mesh.size
        data = _on_device(data, device)
        rdtype = _data_dtype(data)

        def init(v, shape):
            if v is None:
                return torch.zeros(shape, dtype=rdtype, device=device)
            return as_tensor(v).to(device=device, dtype=rdtype)

        xi0, ui0, z0 = init(xi0, (W, n)), init(ui0, (W, n)), init(z0, (n,))
        if tuple(xi0.shape) != (W, n) or tuple(ui0.shape) != (W, n):
            raise ValueError(f"xi0/ui0 must have shape {(W, n)}; got {tuple(xi0.shape)}/"
                             f"{tuple(ui0.shape)}")
        if tuple(z0.shape) != (n,):
            raise ValueError(f"z0 must have shape {(n,)}; got {tuple(z0.shape)}")
        config = resolve_unroll(config, body)
        sync(device)

    t0 = time.perf_counter()
    out = _consensus_solve(local_prox, global_prox, config, W, n, data, xi0, ui0, z0,
                           mesh=mesh)
    sync(device)
    runtime = time.perf_counter() - t0  # before from_raw's host reads
    with span("admm_tpu_torch.result"):
        res = ADMMResults.from_raw({k: v for k, v in out.items() if k not in ("xi", "ui")},
                                   config)
    res.runtime = runtime
    res.extra.update(xi=out["xi"], ui=out["ui"], nshards=W, mesh=mesh)
    return res


# ---- LASSO instantiation (the reference's consensus problem) -------------


def _lasso_local_prox(z, ui, rho, d):
    rhs = d["Dtsi"] + rho * (z[None, :] - ui)
    return torch.einsum("wij,wj->wi", d["Minv"], rhs)


def _lasso_local_prox_dynamic(z, ui, rho, d):
    # rho-parameterized per-shard solve via the batched eigh of D_i^T D_i
    # (valid for any runtime rho — the adaptive/rbadaptive paths).
    rhs = d["Dtsi"] + rho * (z[None, :] - ui)
    y = torch.einsum("wji,wj->wi", d["V"], rhs)
    y = y / (d["w"] + rho)
    return torch.einsum("wij,wj->wi", d["V"], y)


def _lasso_global_prox(xbar, ubar, rho, W, d):
    # soft-threshold at lambda/(rho N) (zminParallelLASSO :1290-1293)
    return soft_threshold(xbar + ubar, d["lam"] / (rho * W))


def _elasticnet_global_prox(xbar, ubar, rho, W, d):
    # prox of lam*(alpha ||z||_1 + (1-alpha)/2 ||z||^2) at weight rho*W.
    t = d["lam"] * d["alpha"] / (rho * W)
    scale = 1.0 + d["lam"] * (1.0 - d["alpha"]) / (rho * W)
    return soft_threshold(xbar + ubar, t) / scale


def _gram(Di):
    return torch.einsum("wij,wik->wjk", Di, Di)


def ls_setup(Di, Si, dynamic: bool, rho: float):
    """Per-shard least-squares solve data at full precision: the Gram
    eigendecomposition (``V``, ``w``) for dynamic rho, else the rho-folded
    inverse ``Minv`` (the reference's per-slice Cholesky caches,
    getProxOps.m:404-442), and ``Dtsi`` = D_i^T s_i; ``Si`` is (W, m/W)
    or, for lanes, (B, W, m/W).  G_i + rho I is positive definite, so its
    inverse goes through Cholesky (``admm_tpu`` takes an LU inverse; a
    multi-threaded batched LU inverse of order 256 and up hangs in some
    CPU builds' LAPACK)."""
    with matmul_precision("highest"):
        G = _gram(Di)
        Dtsi = torch.einsum("wij,...wi->...wj", Di, Si)
        if dynamic:
            w, V = torch.linalg.eigh(0.5 * (G + G.transpose(-1, -2)))
            return {"w": w, "V": V, "Dtsi": Dtsi}
        n = Di.shape[-1]
        G = G + rho * torch.eye(n, dtype=Di.dtype, device=Di.device)[None]
        return {"Minv": torch.cholesky_inverse(torch.linalg.cholesky(G)), "Dtsi": Dtsi}


def _local_rows(D, s, mesh, nshards, device):
    """``(Di, si, W, mesh)``: this rank's block of row shards, stacked
    (W/P, m/W, n) and (W/P, m/W), from either form ``consensus_lasso``
    takes.  A 2-D ``D`` (m, n) with ``s`` (m,) is the whole matrix: its
    rows are zero-padded (exact no-ops for D^T D and D^T s), cut into W
    shards, and the rank's block taken (``Mesh.take``).  A 3-D ``D`` is the
    rank's own block already, ``s`` (W/P, m/W) beside it; W defaults to
    W/P times the ranks (the block itself without a group)."""
    D = as_tensor(D).to(device)
    s = as_tensor(s).to(device=device, dtype=D.dtype)
    if D.ndim == 2 and s.ndim == 1:
        W, mesh = shard_count(mesh, nshards)
        return (mesh.take(shard_rows(pad_rows(D, W)[0], W)),
                mesh.take(shard_rows(pad_rows(s, W)[0], W)), W, mesh)
    if D.ndim != 3 or s.ndim != 2 or tuple(s.shape) != tuple(D.shape[:2]):
        raise ValueError(
            f"D and s must be the whole matrix and signal, (m, n) and (m,), or this rank's "
            f"block of row shards, (W/P, m/W, n) and (W/P, m/W); got {tuple(D.shape)} and "
            f"{tuple(s.shape)}")
    W, mesh = shard_count(mesh, D.shape[0] * mesh.world if nshards is None else nshards)
    if W != D.shape[0] * mesh.world:
        raise ValueError(
            f"a block of {D.shape[0]} shards on each of {mesh.world} rank(s) is "
            f"{D.shape[0] * mesh.world} shards, not nshards={W}")
    return D, s, W, mesh


def _sharded_ls_setup(D, s, config, mesh, nshards, device):
    """Shared consensus setup for least-squares local solves: resolve the
    mesh and shard count, take this rank's row shards (``_local_rows``)
    and build the per-shard solve data, in one ``admm_tpu_torch.setup``
    span.  Returns ``(local_prox, data, n, mesh, W)``; callers add the
    penalty parameters and pick the global prox."""
    with span("admm_tpu_torch.setup"):
        mesh, device = resolve_mesh(mesh, device, D, s)
        Di, si, W, mesh = _local_rows(D, s, mesh, nshards, device)
        data = ls_setup(Di, si, config.dynamic_rho, float(config.rho))
    local = _lasso_local_prox_dynamic if config.dynamic_rho else _lasso_local_prox
    return local, data, Di.shape[-1], mesh, W


def consensus_lasso(
    D,
    s,
    lam,
    config: ADMMConfig = ADMMConfig(),
    *,
    mesh: Optional[Mesh] = None,
    nshards: Optional[int] = None,
    xi0=None,
    ui0=None,
    z0=None,
    device=None,
) -> ADMMResults:
    """Solve LASSO by consensus ADMM with the data rows in W stacked
    shards (solvers/lasso.m:196-224, getProxOps.m:367-442).  ``nshards``
    defaults to the mesh size; ``xi0``/``ui0``/``z0`` warm-start (resume)
    the sharded state (``consensus_admm``).  ``D`` and ``s`` are numpy
    arrays or tensors; the solve runs in D's dtype on ``device``, the
    mesh's device, D's, or the CUDA device.

    ``D`` (m, n) and ``s`` (m,) are the whole problem, whose rows each rank
    shards and cuts its block from.  Or, as in a deployment where each rank
    loads only its own rows, ``D`` is this rank's block of W/P row shards
    stacked (W/P, m/W, n) and ``s`` its (W/P, m/W) signal; ``nshards``
    defaults to W/P times the ranks of the mesh's group (the block itself
    without one).  Shards are taken in rank order: rank r's block is
    shards r W/P to (r + 1) W/P - 1 of the whole, so the two forms of the
    same rows give the same bits.  Any other shape raises ``ValueError``."""
    local_prox, data, n, mesh, W = _sharded_ls_setup(D, s, config, mesh, nshards, device)
    data["lam"] = torch.as_tensor(lam, dtype=data["Dtsi"].dtype, device=mesh.device)
    return consensus_admm(local_prox, _lasso_global_prox, data, n, config, mesh=mesh,
                          nshards=W, xi0=xi0, ui0=ui0, z0=z0)


def consensus_elasticnet(
    D,
    s,
    lam,
    alpha=0.5,
    config: ADMMConfig = ADMMConfig(),
    *,
    mesh: Optional[Mesh] = None,
    nshards: Optional[int] = None,
    xi0=None,
    ui0=None,
    z0=None,
    device=None,
) -> ADMMResults:
    """Elastic net by consensus ADMM: the x-solves of ``consensus_lasso``,
    the elastic-net shrink-and-rescale as the global prox at threshold
    lam*alpha/(rho W).  ``alpha=1`` recovers ``consensus_lasso`` exactly;
    ``D`` and ``s`` take either of its forms."""
    if not 0.0 <= float(alpha) <= 1.0:
        raise ValueError(f"alpha must be in [0, 1], got {alpha}")
    local_prox, data, n, mesh, W = _sharded_ls_setup(D, s, config, mesh, nshards, device)
    dt = data["Dtsi"].dtype
    data["lam"] = torch.as_tensor(lam, dtype=dt, device=mesh.device)
    data["alpha"] = torch.as_tensor(alpha, dtype=dt, device=mesh.device)
    return consensus_admm(local_prox, _elasticnet_global_prox, data, n, config, mesh=mesh,
                          nshards=W, xi0=xi0, ui0=ui0, z0=z0)


# ---- logistic regression instantiation (Boyd et al. 2011, sec. 8.2) -------


def _logreg_fobj(Yi, x, v, rho):
    t = torch.einsum("wmn,wn->wm", Yi, x)
    return torch.sum(_softplus_neg(t), dim=-1) + 0.5 * rho * torch.sum((x - v) ** 2, dim=-1)


def _damped(x, s, f0, fobj):
    """The full step when it descends, else the half, else the quarter."""
    x1, x2 = x - s, x - 0.5 * s
    f1, f2 = fobj(x1), fobj(x2)
    return torch.where((f1 <= f0)[:, None], x1,
                       torch.where((f2 <= f0)[:, None], x2, x - 0.25 * s))


@functools.lru_cache(maxsize=8)
def _logreg_local_prox_fn(newton_steps: int):
    """Per-shard damped-Newton x-prox for sparse logistic regression,
    batched over the shard axis: argmin_x sum softplus(-(Y_i x)) +
    (rho/2)||x - (z - u_i)||^2, restarted from z - u_i every iteration, so
    solved accurately (``admm_tpu``'s 20 steps with three-level damping).
    Zero pad rows are exact no-ops for the gradient and Hessian.  The
    (W, n, n) Newton systems are solved by Cholesky (``cholesky_ex``, no
    status read back), where ``admm_tpu`` takes an LU solve."""

    def prox(z, ui, rho, d):
        Yi = d["Yi"]                           # (W, mw, n)
        n = Yi.shape[-1]
        I = torch.eye(n, dtype=Yi.dtype, device=Yi.device)
        v = z[None, :] - ui                    # (W, n)
        fobj = lambda x: _logreg_fobj(Yi, x, v, rho)  # noqa: E731
        x = v
        for _ in range(newton_steps):
            t = torch.einsum("wmn,wn->wm", Yi, x)
            sig = torch.sigmoid(-t)
            grad = -torch.einsum("wmn,wm->wn", Yi, sig) + rho * (x - v)
            w = sig * (1.0 - sig)
            H = torch.einsum("wmi,wmj->wij", Yi * w[..., None], Yi) + rho * I
            step = cho_solve(cho_factor(H), grad[..., None])[..., 0]
            x = _damped(x, step, fobj(x), fobj)
        return x

    return prox


@functools.lru_cache(maxsize=None)
def _logreg_local_prox_cg_fn(newton_steps: int, cg_steps: int):
    """Matrix-free per-shard Newton-PCG local prox: each CG matvec is two
    (W, mw, n) einsums, no (W, n, n) Hessian stack; restarted from
    z - u_i every iteration, hence ``admm_tpu``'s conservative knobs."""

    def prox(z, ui, rho, d):
        Yi, Yi2 = d["Yi"], d["Yi2"]           # (W, mw, n)
        v = z[None, :] - ui                    # (W, n)
        tiny = torch.finfo(v.dtype).tiny
        fobj = lambda x: _logreg_fobj(Yi, x, v, rho)  # noqa: E731
        x = v
        for _ in range(newton_steps):
            t = torch.einsum("wmn,wn->wm", Yi, x)
            sig = torch.sigmoid(-t)
            grad = -torch.einsum("wmn,wm->wn", Yi, sig) + rho * (x - v)
            w = sig * (1.0 - sig)
            diag = torch.einsum("wmn,wm->wn", Yi2, w) + rho

            def hv(s, w=w):
                return (torch.einsum("wmn,wm->wn", Yi, w * torch.einsum("wmn,wn->wm", Yi, s))
                        + rho * s)

            # Per-shard Jacobi-PCG (reductions over the trailing axis).
            s = torch.zeros_like(grad)
            r = grad
            zp = r / diag
            p = zp
            rz = torch.sum(r * zp, dim=-1, keepdim=True)
            for _ in range(cg_steps):
                hp = hv(p)
                alpha = rz / torch.clamp_min(torch.sum(p * hp, dim=-1, keepdim=True), tiny)
                s = s + alpha * p
                r = r - alpha * hp
                zp = r / diag
                rz_new = torch.sum(r * zp, dim=-1, keepdim=True)
                beta = rz_new / torch.clamp_min(rz, tiny)
                p = zp + beta * p
                rz = rz_new
            x = _damped(x, s, fobj(x), fobj)
        return x

    return prox


def consensus_logreg(
    D,
    ell,
    lam,
    config: ADMMConfig = ADMMConfig(),
    *,
    mesh: Optional[Mesh] = None,
    nshards: Optional[int] = None,
    inner: str = "newton",
    newton_steps: int = 20,
    cg_steps: int = 25,
    xi0=None,
    ui0=None,
    z0=None,
    device=None,
) -> ADMMResults:
    """Distributed sparse logistic regression by consensus ADMM (Boyd et
    al. 2011, sec. 8.2): data rows in W stacked shards, per-shard
    damped-Newton local solves (``inner='newton'``, dense; or
    ``'newton_cg'``, matrix-free), global soft-threshold z at
    lam/(rho W).  Placement as in ``consensus_lasso``."""
    mesh, device = resolve_mesh(mesh, device, D, ell)
    W, mesh = shard_count(mesh, nshards)
    D = as_tensor(D).to(device)
    ell = as_tensor(ell).to(device=device, dtype=D.dtype)
    m, n = D.shape
    if tuple(ell.shape) != (m,):
        raise ValueError(f"ell must be ({m},) labels, got {tuple(ell.shape)}")
    if inner not in ("newton", "newton_cg"):
        raise ValueError(f"inner must be 'newton' or 'newton_cg', got {inner!r}")
    Yi = mesh.take(shard_rows(pad_rows(D * ell[:, None], W)[0], W))   # (W, m/W, n)
    data = {"Yi": Yi, "lam": torch.as_tensor(lam, dtype=D.dtype, device=device)}
    if inner == "newton_cg":
        data["Yi2"] = Yi * Yi
        local = _logreg_local_prox_cg_fn(int(newton_steps), int(cg_steps))
    else:
        local = _logreg_local_prox_fn(int(newton_steps))
    return consensus_admm(local, _lasso_global_prox, data, n, config, mesh=mesh, nshards=W,
                          xi0=xi0, ui0=ui0, z0=z0)


# ---- covariance selection (matrix-iterate consensus) ----------------------
#
# Boyd et al. 2011 ch. 7 general-form consensus applied to the graphical
# lasso, distributed over SAMPLES:
#
#     min sum_i [ tr(S_i X_i) - (1/N) logdet X_i ] + lam ||Z||_1   s.t. X_i = Z
#
# where S_i is shard i's contribution to the pooled covariance (global
# mean and normalization, so the optimum is the serial solve's).  The
# local prox is the covsel spectral function with 4 rho -> 4 rho / N; the
# (p, p) iterates ride flattened (p*p,) through the vector runner.


def _covsel_local_prox(z, ui, rho, d):
    Wn = ui.shape[0]
    p = d["Si"].shape[-1]
    V = (z[None, :] - ui).reshape(Wn, p, p)
    X = covsel_eig_prox(rho * V - d["Si"], rho, weight=d["wgt"])
    return X.reshape(Wn, p * p)


@functools.lru_cache(maxsize=None)
def _covsel_local_prox_ns_fn(ns_iters: int, ns_coarse: int, ns_correct: int):
    """The Newton-Schulz local prox with its knobs bound (cached, so one
    set of knobs gives one function)."""

    def prox(z, ui, rho, d):
        Wn = ui.shape[0]
        p = d["Si"].shape[-1]
        V = (z[None, :] - ui).reshape(Wn, p, p)
        X = covsel_ns_prox(rho * V - d["Si"], rho, ns_iters, ns_coarse, ns_correct,
                           weight=d["wgt"])
        return X.reshape(Wn, p * p)

    return prox


def _flat_mat(v, shape, dtype, device, what):
    if v is None:
        return None
    v = as_tensor(v).to(device=device, dtype=dtype)
    if tuple(v.shape) != shape:
        raise ValueError(f"{what} must have shape {shape}, got {tuple(v.shape)}")
    return v.reshape(shape[:-2] + (shape[-1] * shape[-2],))


def _covsel_prox(prox_method, ns_iters, ns_coarse, ns_correct):
    if prox_method not in ("eigh", "ns", "ns_fast"):
        raise ValueError(
            f"prox_method must be 'eigh', 'ns' or 'ns_fast', got {prox_method!r}")
    if prox_method == "eigh":
        return _covsel_local_prox
    if prox_method == "ns_fast":
        # All reduced-precision square-root steps + 2 full-precision
        # corrections (models/covarianceselection.py's recipe).
        ns_coarse, ns_correct = ns_iters, max(int(ns_correct), 2)
    return _covsel_local_prox_ns_fn(int(ns_iters), int(ns_coarse), int(ns_correct))


def covsel_setup(Di):
    """Per-shard covariance contributions S_i = D_i^T D_i (rows already
    globally centered and 1/sqrt(m-1)-scaled), symmetrized, at full
    precision; takes leading lane axes."""
    with matmul_precision("highest"):
        G = torch.einsum("...mi,...mj->...ij", Di, Di)
        return 0.5 * (G + G.transpose(-1, -2))


def consensus_covsel(
    D,
    lam,
    config: ADMMConfig = ADMMConfig(),
    *,
    mesh: Optional[Mesh] = None,
    nshards: Optional[int] = None,
    prox_method: str = "eigh",
    ns_iters: int = 20,
    ns_coarse: int = 0,
    ns_correct: int = 0,
    xi0=None,
    ui0=None,
    z0=None,
    device=None,
) -> ADMMResults:
    """Distributed covariance selection by consensus ADMM: sample rows of
    ``D`` (m, p) in W stacked shards, per-shard spectral local proxes on
    (p, p) matrix iterates (``'eigh'`` exact, ``'ns'``/``'ns_fast'`` the
    matmul-only Newton-Schulz tier), global soft-threshold Z.  The optimum
    equals the serial ``covarianceselection(D, lam)``.  Warm starts
    ``xi0``/``ui0`` take (W, p, p) stacks, ``z0`` a (p, p) matrix; results
    are matrices (``extra['xi']``/``['ui']`` as (W, p, p)).  Placement as
    in ``consensus_lasso``."""
    local = _covsel_prox(prox_method, ns_iters, ns_coarse, ns_correct)
    mesh, device = resolve_mesh(mesh, device, D)
    W, mesh = shard_count(mesh, nshards)
    D = as_tensor(D).to(device)
    m, p = D.shape
    # Global centering + normalization BEFORE sharding, so that
    # sum_i S_i = empirical_covariance(D) exactly.
    Dc = (D - D.mean(dim=0, keepdim=True)) / math.sqrt(m - 1)
    Si = covsel_setup(mesh.take(shard_rows(pad_rows(Dc, W)[0], W)))  # (W, p, p) local Grams
    dt = Si.dtype
    data = {"Si": Si, "lam": torch.as_tensor(lam, dtype=dt, device=device),
            "wgt": torch.as_tensor(1.0 / W, dtype=dt, device=device)}
    res = consensus_admm(
        local, _lasso_global_prox, data, p * p, config, mesh=mesh, nshards=W,
        xi0=_flat_mat(xi0, (W, p, p), dt, device, "xi0"),
        ui0=_flat_mat(ui0, (W, p, p), dt, device, "ui0"),
        z0=_flat_mat(z0, (p, p), dt, device, "z0"), body="heavy")
    res.xopt, res.zopt, res.uopt = (v.reshape(p, p) for v in (res.xopt, res.zopt, res.uopt))
    res.extra["xi"] = res.extra["xi"].reshape(W, p, p)
    res.extra["ui"] = res.extra["ui"].reshape(W, p, p)
    return res


# ---- lanes x shards: B instances, each row-sharded W ways -----------------


def _consensus_batch(local, global_prox, data, mapped, sharded, cfg, W, n, xi0, ui0, z0, Bn,
                     device, rdtype, body, mesh):
    """Run B consensus lanes as one program (``torch.func.vmap`` over the
    step, a freeze select at every sub-step); returns the raw dict and the
    loop's wall time.  ``mapped`` names the data keys stacked over lanes
    and ``sharded`` those with a shard axis (dim 1 of a mapped key, dim 0
    of a shared one).  Over ``mesh``'s process group each rank runs its
    part (``Mesh.lane_layout``): its lanes with every shard, or, with a
    lane row over several ranks, its row's lanes with its block of shards,
    the shard-axis means over the row's subgroup.  The results come back
    whole through one ``all_gather``."""
    def init(v, shape, what):
        if v is None:
            return torch.zeros(shape, dtype=rdtype, device=device)
        v = as_tensor(v).to(device=device, dtype=rdtype)
        if tuple(v.shape) != shape:
            raise ValueError(f"{what} must have shape {shape}; got {tuple(v.shape)}")
        return v

    xi0 = init(xi0, (Bn, W, n), "xi0/ui0")
    ui0 = init(ui0, (Bn, W, n), "xi0/ui0")
    z0 = init(z0, (Bn, n), "z0")
    cfg = resolve_unroll(cfg, body)
    dims = {k: (0 if k in mapped else None) for k in data}
    lay = mesh.lane_layout(Bn, W)

    def part(k, v):
        if k in mapped:
            v = v[lay.lanes]
            return v[:, lay.shards] if k in sharded else v
        return v[lay.shards] if k in sharded else v

    data = {k: part(k, v) for k, v in data.items()}
    rows = lay.lanes
    sync(device)
    t0 = time.perf_counter()
    out = _consensus_solve(local, global_prox, cfg, W, n, data, xi0[rows], ui0[rows], z0[rows],
                           data_dims=dims, mesh=lay.inner, agree=lay.agree)
    sync(device)
    runtime = time.perf_counter() - t0
    out = gather_lanes(mesh, lay, out, sharded=("xi", "ui"))
    if lay.span > 1:
        out["xopt"], out["uopt"] = torch.mean(out["xi"], dim=-2), torch.mean(out["ui"], dim=-2)
    return out, runtime


def _batch_results(out, runtime, W, mesh, shape=None):
    from ..models.batch import BatchResults

    Bn = out["zopt"].shape[0]
    r = (lambda v: v) if shape is None else (lambda v: v.reshape((Bn,) + shape))  # noqa: E731
    ri = (lambda v: v) if shape is None else (lambda v: v.reshape((Bn, W) + shape))  # noqa: E731
    return BatchResults(
        xopt=r(out["xopt"]), zopt=r(out["zopt"]), uopt=r(out["uopt"]), steps=out["steps"],
        rho_final=out["rho_final"], runtime=runtime, hist=out["hist"],
        extra={"xi": ri(out["xi"]), "ui": ri(out["ui"]), "nshards": W, "mesh": mesh,
               "stalled": out["stalled"]})


def _lane_values(v, Bn, dtype, device):
    """A scalar or (B,) lane parameter as a (B,) tensor."""
    return torch.broadcast_to(torch.as_tensor(as_tensor(v), dtype=dtype, device=device),
                              (Bn,)).contiguous()


def _consensus_ls_batch(D, S, penalties, global_prox, config, *, mesh, nshards, xi0, ui0, z0,
                        what, device):
    """The lanes x shards consensus core of the shrinkage family: per-shard
    least-squares local solves on one shared D, a per-lane signal, the
    global prox at per-lane ``penalties`` (scalars or (B,) values)."""
    mesh, device = resolve_mesh(mesh, device, D, S, ndim=2)
    if len(mesh.axis_names) != 2:
        raise ValueError(f"{what} needs a 2-D (lanes, shards) mesh; got axes {mesh.axis_names}")
    D = as_tensor(D).to(device)
    S = as_tensor(S).to(device=device, dtype=D.dtype)
    m, n = D.shape
    if S.ndim != 2 or S.shape[1] != m:
        raise ValueError(f"S must be (B, {m}) signal lanes, got {tuple(S.shape)}")
    Bn = S.shape[0]
    W = lane_shard_count(mesh, nshards, Bn, what)
    Dp, _ = pad_rows(D, W)
    Di = shard_rows(Dp, W)                                   # (W, m/W, n)
    Sib = torch.cat((S, S.new_zeros((Bn, Dp.shape[0] - m))), dim=1).reshape(Bn, W, -1)
    data = ls_setup(Di, Sib, config.dynamic_rho, float(config.rho))
    local = _lasso_local_prox_dynamic if config.dynamic_rho else _lasso_local_prox
    mapped = {"Dtsi"} | set(penalties)
    for key, val in penalties.items():
        data[key] = _lane_values(val, Bn, D.dtype, device)
    out, runtime = _consensus_batch(local, global_prox, data, mapped, {"Dtsi", "Minv", "V", "w"},
                                    config, W, n, xi0, ui0, z0, Bn, device, D.dtype, "gemv",
                                    mesh)
    return _batch_results(out, runtime, W, mesh)


def consensus_lasso_batch(
    D,
    S,
    lams,
    config: ADMMConfig = ADMMConfig(),
    *,
    mesh: Optional[Mesh] = None,
    nshards: Optional[int] = None,
    xi0=None,
    ui0=None,
    z0=None,
    device=None,
):
    """B independent LASSO instances — one shared dictionary ``D``, a
    per-lane signal ``S[b]`` and penalty ``lams[b]`` — each solved by
    consensus ADMM with its rows in W shards, as one program over a 2-D
    (lanes x shards) mesh (default 1 lane x all devices; over a process
    group, every device of every rank, the shard axis over the ranks, as
    ``admm_tpu``'s default over a cluster).  B must divide
    over the lane axis and ``nshards`` (default: the shard-axis size) over
    the shard axis.  ``xi0``/``ui0`` (B, W, n) and ``z0`` (B, n) warm-start
    the lanes.  Returns ``models.batch.BatchResults`` with the final
    per-lane xi/ui in ``extra``; converged lanes freeze."""
    return _consensus_ls_batch(D, S, {"lam": lams}, _lasso_global_prox, config, mesh=mesh,
                               nshards=nshards, xi0=xi0, ui0=ui0, z0=z0,
                               what="consensus_lasso_batch", device=device)


def consensus_elasticnet_batch(
    D,
    S,
    lams,
    alphas=0.5,
    config: ADMMConfig = ADMMConfig(),
    *,
    mesh: Optional[Mesh] = None,
    nshards: Optional[int] = None,
    xi0=None,
    ui0=None,
    z0=None,
    device=None,
):
    """Elastic net over the lanes x shards mesh: ``consensus_lasso_batch``'s
    local solves, the shrink-and-rescale global prox at per-lane
    (lam, alpha).  ``alphas=1`` recovers ``consensus_lasso_batch``."""
    a = as_tensor(alphas).double()
    if bool(torch.any(a < 0.0)) or bool(torch.any(a > 1.0)):
        raise ValueError(f"alphas must be in [0, 1], got {alphas}")
    return _consensus_ls_batch(D, S, {"lam": lams, "alpha": alphas}, _elasticnet_global_prox,
                               config, mesh=mesh, nshards=nshards, xi0=xi0, ui0=ui0, z0=z0,
                               what="consensus_elasticnet_batch", device=device)


def consensus_covsel_batch(
    Ds,
    lams,
    config: ADMMConfig = ADMMConfig(),
    *,
    mesh: Optional[Mesh] = None,
    nshards: Optional[int] = None,
    prox_method: str = "eigh",
    ns_iters: int = 20,
    ns_coarse: int = 0,
    ns_correct: int = 0,
    xi0=None,
    ui0=None,
    z0=None,
    device=None,
):
    """B independent covariance-selection instances — a cohort, each with
    its own (m, p) samples ``Ds[b]`` and penalty ``lams[b]`` — each solved
    by sample-sharded consensus ADMM, as one program over a 2-D (lanes x
    shards) mesh.  Returns ``models.batch.BatchResults`` with (B, p, p)
    iterates (``extra['xi']``/``['ui']`` as (B, W, p, p) for resume)."""
    local = _covsel_prox(prox_method, ns_iters, ns_coarse, ns_correct)
    mesh, device = resolve_mesh(mesh, device, Ds, ndim=2)
    if len(mesh.axis_names) != 2:
        raise ValueError(f"consensus_covsel_batch needs a 2-D (lanes, shards) mesh; got "
                         f"axes {mesh.axis_names}")
    Ds = as_tensor(Ds).to(device)
    if Ds.ndim != 3:
        raise ValueError(f"Ds must be (B, m, p) sample stacks, got {tuple(Ds.shape)}")
    Bn, m, p = Ds.shape
    W = lane_shard_count(mesh, nshards, Bn, "consensus_covsel_batch")
    # Per-lane global centering + normalization, then row-shard each lane.
    Dc = (Ds - Ds.mean(dim=1, keepdim=True)) / math.sqrt(m - 1)
    mw = -(-m // W)
    Dp = torch.cat((Dc, Dc.new_zeros((Bn, mw * W - m, p))), dim=1)
    Sib = covsel_setup(Dp.reshape(Bn, W, mw, p))             # (B, W, p, p)
    dt = Sib.dtype
    data = {"Si": Sib, "lam": _lane_values(lams, Bn, dt, device),
            "wgt": torch.as_tensor(1.0 / W, dtype=dt, device=device)}
    nn = p * p
    flat = lambda v, shape: None if v is None else as_tensor(v).reshape(shape)  # noqa: E731
    out, runtime = _consensus_batch(local, _lasso_global_prox, data, {"Si", "lam"}, {"Si"},
                                    config, W, nn, flat(xi0, (Bn, W, nn)), flat(ui0, (Bn, W, nn)),
                                    flat(z0, (Bn, nn)), Bn, device, dt, "heavy", mesh)
    return _batch_results(out, runtime, W, mesh, shape=(p, p))
