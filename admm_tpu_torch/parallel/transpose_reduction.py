"""Distributed unwrapped ADMM with transpose reduction (port of
``admm_tpu/parallel/transpose_reduction.py``).

The reference's clearest multi-node pattern (solvers/unwrappedadmm.m:96-141
+ zminParallelLinearSVM, getProxOps.m:1120-1143): rows of D are sliced
across workers; each iteration does

    d_i = D_i^T (z_i - u_i)        [local matvec]
    d   = sum_i d_i                [sum over the shard axis]
    x   = W^{-1} d,  W = sum_i D_i^T D_i   [replicated solve]
    z_i = prox_g(D_i x + u_i, ...) [local]
    u_i = u_i + D_i x - z_i        [local]

Here the W shards are dim 0 of (W, m/W, ...) tensors on one device
(``mesh.Mesh``), or each rank's block of them over a process group; the
reduce-sum goes through ``Mesh.psum`` and the replicated solve is one
n-by-n GEMV against the precomputed W^+ (pinv, rank-deficient D degrades
gracefully; W^+ is independent of rho, so rho adaptation never
refactors).  A step issues two collectives: the n-float psi-sum
sum_i D_i^T v_i, and one packing every shard-axis sum of the norms (three
scalars, plus the two n-float dual sums D^T dz and D^T u when the dual
test runs, two scalars for the alg-2 d-value and two for the H-norm).
The row-space results z/u come back whole through one ``all_gather``,
the objective's shard sum through one more collective.

Stopping preserved from the unwrapped driver (unwrappedadmm.m:81-92):
``linearsvm_sharded`` forces stopcond='both' with nodualerror.  The runner
carries the core engine's variants over the sharded state: fast and
accelerated momentum, relaxation, the dual Boyd test, the convtest
monitor, adaptive and residual-balancing rho, Anderson acceleration over
the row-space pair (z, u) (``anderson.py``), the stall window and the
x record.

Padding: rows are zero-padded to equal shards and carry a zero mask
entry, so prox and objective treat them as absent; their z/u stay zero.
The random start is the port's own (``models/unwrapped.random_start``
over the padded length: torch's CPU generator, not ``jax.random``), so
parity with ``admm_tpu`` carries x0/z0/u0 across.
"""

from __future__ import annotations

import dataclasses
import math
import time
from typing import Callable, Optional

import torch

from ..anderson import AndersonWindow
from ..config import ADMMConfig, matmul_precision, resolve_unroll
from ..engine import (adaptive_rho_update, fast_update, fro2, history, residual_balance_factor,
                      run_steps, sync, traces)
from ..models._common import as_tensor
from ..models.unwrapped import random_start
from ..ops.prox import hinge_prox, zero_one_prox
from ..results import ADMMResults
from ._loop import gather_lanes
from .mesh import Mesh, lane_shard_count, pad_rows, resolve_mesh, shard_count, shard_rows


def gram_pinv(Di, mesh: Optional[Mesh] = None):
    """W^+ of W = sum_i D_i^T D_i (unwrappedadmm.m:96-123): the per-shard
    Grams summed over the shard axis (over ``mesh``'s ranks when it has a
    group), symmetrized, then a pseudo-inverse, at full precision."""
    with matmul_precision("highest"):
        G = torch.einsum("wij,wik->jk", Di, Di)
        if mesh is not None:
            G = mesh.psum(G)
        return torch.linalg.pinv(0.5 * (G + G.T))


def _names(cfg):
    return (["pnorm", "perr", "dnorm", "derr"] + (["Hnormsq"] if cfg.needs_hnorm else [])
            + (["dvals"] if cfg.alg == 2 else []) + (["avals"] if cfg.alg else []))


def _make_unwrapped_step(prox_g_shard, cfg: ADMMConfig, m: int, window, mesh: Mesh):
    """One unwrapped-ADMM iteration over the sharded state (``admm_tpu``'s
    ``_make_unwrapped_run`` step) as the ``(xupdate, tail)`` pair of
    ``engine.run_steps``: the engine's update order with A = D, B = -I,
    c = 0 specialized per shard.  ``data`` holds ``Di``, ``Winv``,
    ``mask`` and ``aux``; ``mesh`` sums over the shard axis."""
    alg = cfg.alg
    relax = float(cfg.relax)
    use_relax = relax != 1.0
    needs_h = cfg.needs_hnorm
    std_stop = cfg.stopcond in ("standard", "both")
    h_stop = cfg.stopcond in ("hnorm", "both")
    need_dual = not cfg.nodualerror
    use_stall = cfg.use_stall
    sqm = math.sqrt(float(m))  # true row count: padding excluded from the error bar
    rho0 = float(cfg.rho)

    def xupdate(c, d):
        # Local matvec, sum over shards, replicated GEMV.
        src = c["z"] - c["u"] if alg == 0 else c["v"] - c["uhat"]
        return d["Winv"] @ mesh.psum(torch.einsum("wij,wi->j", d["Di"], src))

    def tail(c, bufs, d, x, frozen, slot, put):
        Di, mask, aux = d["Di"], d["mask"], d["aux"]
        rho = c["rho"]
        eps = torch.finfo(rho.dtype).eps
        no = torch.zeros_like(c["done"])
        nan = torch.full_like(rho, float("nan"))
        k = c["k"]
        i = k + 1
        zi, ui = c["z"], c["u"]
        zprev = zi
        if alg == 0:
            u_base = ui
        else:
            uprev, uhat = ui, c["uhat"]
            u_base = uhat
        Dx = torch.einsum("wij,j->wi", Di, x)

        # B = -I, c = 0: Axhat = relax*Dx - (1-relax)*(-zprev).
        Axr = relax * Dx + (1.0 - relax) * zprev if use_relax else Dx
        zi = prox_g_shard(Axr, zi, u_base, rho, aux) * mask
        ui = u_base + (Axr - zi) * mask

        new = {}
        if alg == 1:
            v_new, uhat_new, a_new, _, _ = fast_update(
                alg, cfg, aprev=c["a"], dprev=None, z=zi, zprev=zprev, u=ui, uprev=uprev,
                v=c["v"])
            new.update(v=v_new, uhat=uhat_new, a=a_new)

        # Every shard-axis sum of the norms in one collective; the norms
        # are on the true residual D x - z (unrelaxed), as the engine's.
        r = (Dx - zi) * mask
        parts = [fro2(r), fro2(Dx * mask), fro2(zi)]
        if need_dual:
            dz = zi - (v_new if alg == 1 else zprev)
            parts += [torch.einsum("wij,wi->j", Di, dz), torch.einsum("wij,wi->j", Di, ui)]
        if alg == 2:
            parts += [fro2(ui - uhat), fro2(zi - c["v"])]
        if needs_h:
            wz_new, wu_new = zi, rho * ui
            parts += [fro2(c["wz"] - wz_new), fro2(c["wu"] - wu_new)]
        sums = list(mesh.psum(*parts))
        r2, dx2, z2 = sums[:3]
        del sums[:3]

        if alg == 2:
            du2, dv2 = sums[-4:-2] if needs_h else sums[-2:]
            dval = (1.0 / rho) * du2 + rho * dv2
            v_new, uhat_new, a_new, d_new, restarted_i = fast_update(
                alg, cfg, aprev=c["a"], dprev=c.get("d"), z=zi, zprev=zprev, u=ui,
                uprev=uprev, v=c["v"], dval=dval)
            new.update(v=v_new, uhat=uhat_new, a=a_new, d=d_new)

        pnorm = torch.sqrt(r2)
        perr = sqm * cfg.abstol + cfg.reltol * torch.maximum(torch.sqrt(dx2), torch.sqrt(z2))
        if need_dual:
            dnorm = rho * torch.sqrt(fro2(sums[0]))
            derr = sqm * cfg.abstol + cfg.reltol * rho * torch.sqrt(fro2(sums[1]))
        else:
            dnorm = derr = nan

        diverged_i = ~torch.isfinite(pnorm) if cfg.nanguard else no
        if needs_h:
            Hsq = rho0 * sums[-2] + rho0 * sums[-1]
            if cfg.convtest and alg == 0:
                H1 = c["Hprev"]
                diverged_i = diverged_i | ((i >= 2) & (H1 > eps) & (Hsq > H1)
                                           & ((Hsq - H1) > H1 * cfg.convtol))
            new.update(wz=wz_new, wu=wu_new, Hprev=Hsq)

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
            if need_dual:
                stop = stop & (dnorm < derr)
        if h_stop and not cfg.domaxiters and needs_h:
            stop = stop | ((i > 2) & (Hsq <= cfg.hnormtol))
        done = stop | diverged_i | stall_i

        rho_new = rho
        if cfg.adaptive and cfg.convtest and needs_h:
            rho_new = adaptive_rho_update(cfg, Hprev=c["Hprev"], Hsq=Hsq, rho=rho, i=i,
                                          done=done, eps=eps)
        elif cfg.rbadaptive and alg == 0:
            factor = residual_balance_factor(cfg, pnorm=pnorm, dnorm=dnorm, done=done,
                                             dtype=rho.dtype)
            rho_new = rho * factor
            ui = ui / factor

        z_next, u_next = zi, ui
        if window is not None:
            (z_next, u_next), acnt, abest, bufs["aF"], bufs["aT"] = window.step(
                [zprev, c["u"]], [zi, ui], c["acnt"], c["abest"], bufs["aF"], bufs["aT"],
                done=done, frozen=frozen, put=put)
            new.update(acnt=acnt, abest=abest)

        vals = ([pnorm, perr, dnorm, derr] + ([Hsq] if needs_h else [])
                + ([d_new] if alg == 2 else []) + ([a_new] if alg else []))
        bufs["hist"] = put(bufs["hist"], 1, slot, torch.stack(vals).reshape(-1, 1))
        if alg == 2:
            bufs["restarted"] = put(bufs["restarted"], 0, slot, restarted_i.reshape(1))
        if cfg.record_iterates:
            bufs["xvals"] = put(bufs["xvals"], 0, slot, x.unsqueeze(0))

        new.update(k=k + 1, x=x, z=z_next, u=u_next, rho=rho_new, done=done,
                   diverged=c["diverged"] | diverged_i, stalled=c["stalled"] | stall_i)
        return new, bufs

    return xupdate, tail


def _unwrapped_solve(prox_g_shard, obj_shard, obj_global, cfg: ADMMConfig, m: int, data,
                     x0, z0, u0, data_dims=None, mesh: Optional[Mesh] = None,
                     local_state: bool = False, agree=None) -> dict:
    """Run the unwrapped iteration from (x0, z0, u0); ``data`` holds
    ``Di`` (W, m/W, n), ``Winv`` (n, n), ``mask`` (W, m/W) and ``aux`` (a
    tuple of per-row (W, m/W) tensors), and z0/u0 are (W, m/W) — over
    ``mesh``'s process group, this rank's block of shards, the row-space
    results coming back whole (with ``local_state``, staying this rank's
    block).  Returns the raw result dict; with ``data_dims`` the state
    carries a leading lane axis, the shards are ``mesh``'s (the whole of
    them, or this rank's block over a lane row's subgroup) and ``agree``
    is ``engine.run_steps``'s."""
    mesh = Mesh((1,), ("shards",), x0.device) if mesh is None else mesh
    lead = tuple(x0.shape[:-1])
    rdtype, device = x0.dtype, x0.device
    N, alg = int(cfg.maxiters), cfg.alg
    full = lambda v: torch.full(lead, v, dtype=rdtype, device=device)  # noqa: E731
    false = torch.zeros(lead, dtype=torch.bool, device=device)
    z0, u0 = z0 * data["mask"], u0 * data["mask"]
    names = _names(cfg)
    mp = data["mask"].numel()
    window = (AndersonWindow(cfg, [mp, mp], dtype=rdtype, device=device,
                             sharded=[True, True], psum=mesh.psum)
              if cfg.anderson > 0 else None)

    s = {"k": torch.zeros(lead, dtype=torch.int64, device=device), "x": x0, "z": z0, "u": u0,
         "rho": full(cfg.rho), "done": false, "diverged": false, "stalled": false}
    if alg:
        s.update(v=z0, uhat=u0, a=full(1.0))
        if alg == 2:
            s["d"] = full(float("inf"))
    if cfg.needs_hnorm:
        s.update(wz=z0, wu=cfg.rho * u0, Hprev=full(float("inf")))
    if cfg.use_stall:
        s.update(best_p=full(float("inf")),
                 since=torch.zeros(lead, dtype=torch.int64, device=device))
    bufs = {"hist": history(names, N, lead, rdtype, device)}
    if alg == 2:
        bufs["restarted"] = torch.zeros(lead + (N + 1,), dtype=torch.int32, device=device)
    if cfg.record_iterates:
        bufs["xvals"] = torch.zeros(lead + (N + 1, x0.shape[-1]), dtype=rdtype, device=device)
    if window is not None:
        bufs["aF"], bufs["aT"] = window.rings(lead)
        s["acnt"], s["abest"] = window.initial(lead)

    xupdate, tail = _make_unwrapped_step(prox_g_shard, cfg, m, window, mesh)
    with matmul_precision(cfg.matmul_precision):
        s, bufs = run_steps(xupdate, tail, s, bufs, data, N, int(cfg.unroll),
                            data_dims=data_dims, agree=agree)
        objopt = None
        if obj_shard is not None or obj_global is not None:
            def objective(x, zi, d):
                Dx = torch.einsum("wij,j->wi", d["Di"], x)
                out = torch.zeros((), dtype=x.dtype, device=x.device)
                if obj_shard is not None:
                    out = out + mesh.psum(obj_shard(x, Dx, zi, d["aux"]))
                if obj_global is not None:
                    out = out + obj_global(x)
                return out
            if data_dims is not None:
                objopt = torch.func.vmap(objective, in_dims=(0, 0, data_dims))(s["x"], s["z"],
                                                                               data)
            else:
                objopt = objective(s["x"], s["z"], data)
    z, u = s["z"], s["u"]
    if data_dims is None and not local_state:
        z, u = mesh.gather(z, u)
    return {"steps": s["k"], "xopt": s["x"], "zopt": z, "uopt": u,
            "rho_final": s["rho"], "diverged": s["diverged"], "stalled": s["stalled"],
            "objopt": objopt, "hist": traces(names, bufs, N, lanes=data_dims is not None)}


def unwrapped_admm_sharded(
    prox_g_shard: Callable,
    D,
    config: ADMMConfig = ADMMConfig(),
    *,
    aux=None,
    obj_shard: Optional[Callable] = None,
    obj_global: Optional[Callable] = None,
    mesh: Optional[Mesh] = None,
    nshards: Optional[int] = None,
    seed: int = 0,
    x0=None,
    z0=None,
    u0=None,
    device=None,
) -> ADMMResults:
    """Row-sharded unwrapped ADMM.

    ``prox_g_shard(Dx_i, z_i, u_i, rho, aux_i)`` maps per-shard (W, m/W)
    tensors to the new z_i; under relaxation the first argument is the
    relaxed Axhat_i, as the serial engine hands prox_g.  ``aux`` is a
    tuple of per-row arrays (m,) sharded alongside D (e.g. labels and the
    pad mask).  ``obj_shard(x, Dx_i, z_i, aux_i)`` returns a scalar summed
    over shards; ``obj_global(x)`` adds the replicated term.

    ``x0`` (n,) / ``z0`` / ``u0`` (m,) warm-start the solve (reference
    options.x0/z0/u0), overriding the random start (``random_start(seed,
    n, padded m)``; without padding the serial solver's own start).  The
    solve runs in D's dtype on ``device``, the mesh's device, D's, or the
    CUDA device.  Over a mesh with a process group each rank takes its
    block of D's row shards (and of ``aux``, z0, u0) and every rank gets
    the whole results.
    """
    mesh, device = resolve_mesh(mesh, device, D)
    W, mesh = shard_count(mesh, nshards)
    D = as_tensor(D).to(device)
    m, n = D.shape
    Dp, n_pad = pad_rows(D, W)
    mp = Dp.shape[0]
    dtype = D.dtype
    if x0 is not None and tuple(as_tensor(x0).shape) != (n,):
        raise ValueError(f"x0 must have shape {(n,)}; got {tuple(as_tensor(x0).shape)}")

    def shard(a):
        return shard_rows(pad_rows(as_tensor(a).to(device=device, dtype=dtype), W)[0], W)

    mrow = torch.zeros(mp, dtype=dtype, device=device)
    mrow[:m] = 1.0
    x_r, z_r, u_r = random_start(seed, n, mp, dtype, device)

    def row_state(v0, drawn, name):
        if v0 is None:
            return drawn.reshape(W, mp // W)
        if tuple(as_tensor(v0).shape) != (m,):
            raise ValueError(f"{name} must have shape {(m,)}; got {tuple(as_tensor(v0).shape)}")
        return shard(v0)

    take = mesh.take
    data = {"Di": take(shard_rows(Dp, W)), "mask": take(shard_rows(mrow, W)),
            "aux": tuple(take(shard(a)) for a in aux) if aux is not None else ()}
    data["Winv"] = gram_pinv(data["Di"], mesh)
    x0 = x_r if x0 is None else as_tensor(x0).to(device=device, dtype=dtype)
    z0, u0 = take(row_state(z0, z_r, "z0")), take(row_state(u0, u_r, "u0"))
    config = resolve_unroll(config, "gemv")

    sync(device)
    t0 = time.perf_counter()
    out = _unwrapped_solve(prox_g_shard, obj_shard, obj_global, config, m, data, x0, z0, u0,
                           mesh=mesh)
    sync(device)
    runtime = time.perf_counter() - t0
    res = ADMMResults.from_raw(out, config)
    res.runtime = runtime
    res.extra.update(nshards=W, mesh=mesh, n_pad=n_pad)
    return res


# The SVM's per-shard functions (per-row C rides in aux: per-sample
# weighting for free).
def _svm_prox_hinge(Dx, zi, ui, rho, aux_i):
    ell_i, mask_i, C_i = aux_i
    return hinge_prox(Dx + ui, ell_i, C_i, rho)


def _svm_prox_01(Dx, zi, ui, rho, aux_i):
    ell_i, mask_i, C_i = aux_i
    # Guard padded rows (C_i = 0 there) against 0-division in rho/C.
    return zero_one_prox(Dx + ui, ell_i, torch.where(C_i > 0, C_i, 1.0), rho)


def _svm_obj_hinge(x, Dx, zi, aux_i):
    ell_i, mask_i, C_i = aux_i
    return torch.sum(C_i * torch.clamp_min(1.0 - ell_i * Dx, 0.0) * mask_i)


def _svm_obj_01(x, Dx, zi, aux_i):
    ell_i, mask_i, C_i = aux_i
    return torch.sum(C_i * torch.clamp_min(torch.sign(1.0 - ell_i * Dx), 0.0) * mask_i)


def _svm_obj_global(x):
    return 0.5 * torch.sum(x * x)


def _is_01(loss):
    return str(loss).replace("-", "") in ("01", "zeroone")


def _svm_fns(loss):
    """(prox, objective) of the hinge or 0-1 loss."""
    return (_svm_prox_01, _svm_obj_01) if _is_01(loss) else (_svm_prox_hinge, _svm_obj_hinge)


def linearsvm_sharded(
    D, ell, C, config: ADMMConfig = ADMMConfig(), *, loss: str = "hinge",
    mesh: Optional[Mesh] = None, nshards: Optional[int] = None, seed: int = 0,
    x0=None, z0=None, u0=None, device=None,
) -> ADMMResults:
    """Distributed linear SVM: the reference's parallel path
    (linearsvm.m:169-206 -> unwrappedadmm parfor branch ->
    zminParallelLinearSVM, getProxOps.m:1120-1143), hinge or 0-1 loss."""
    ell = as_tensor(ell)
    prox, obj = _svm_fns(loss)
    # Stopping defaults preserved from the unwrapped driver.
    cfg = dataclasses.replace(config, stopcond="both", nodualerror=True)
    return unwrapped_admm_sharded(
        prox, D, cfg, aux=(ell, torch.ones_like(ell), torch.full_like(ell, float(C))),
        obj_shard=obj, obj_global=_svm_obj_global, mesh=mesh, nshards=nshards, seed=seed,
        x0=x0, z0=z0, u0=u0, device=device)


def svm_batch_sharded(
    D, ells, C, config: ADMMConfig = ADMMConfig(), *, loss: str = "hinge",
    mesh=None, nshards: Optional[int] = None, seed: int = 0,
    x0=None, z0=None, u0=None, device=None,
):
    """One-vs-all SVM over a 2-D (lanes x shards) mesh: B classifiers (label
    rows ``ells`` of shape (B, m), shared ``D``) each trained by row-sharded
    transpose-reduction ADMM, in one program (``torch.func.vmap`` over the
    step).  D's shards, W^+ and the pad mask are shared by the lanes.
    Lane b's random start is the next draw of one ``random_start``
    generator (x0, z0, u0 of lane 0, then of lane 1, ...); explicit ``x0``
    (B, n) / ``z0``/``u0`` (B, m) override.  Returns
    ``models.batch.BatchResults``.  Over a mesh with a process group each
    rank runs its part (``Mesh.lane_layout``: its lanes with every shard,
    or its lane row's lanes with its block of shards, the shard-axis sums
    over the row's subgroup), and the results come back whole through one
    ``all_gather``."""
    from ..models.batch import BatchResults

    mesh, device = resolve_mesh(mesh, device, D, ells, ndim=2)
    if len(mesh.axis_names) != 2:
        raise ValueError(f"svm_batch_sharded needs a 2-D (lanes, shards) mesh; got "
                         f"axes {mesh.axis_names}")
    D = as_tensor(D).to(device)
    m, n = D.shape
    dtype = D.dtype
    ells = as_tensor(ells).to(device=device, dtype=dtype)
    if ells.ndim != 2 or ells.shape[1] != m:
        raise ValueError(f"ells must be (B, {m}) label lanes, got {tuple(ells.shape)}")
    Bn = ells.shape[0]
    W = lane_shard_count(mesh, nshards, Bn, "svm_batch_sharded")
    prox, obj = _svm_fns(loss)
    cfg = resolve_unroll(dataclasses.replace(config, stopcond="both", nodualerror=True), "gemv")

    Dp, _ = pad_rows(D, W)
    mp = Dp.shape[0]
    mw = mp // W
    Di = shard_rows(Dp, W)
    mrow = torch.zeros(mp, dtype=dtype, device=device)
    mrow[:m] = 1.0
    pad = lambda v: torch.cat((v, v.new_zeros((Bn, mp - m))), dim=1)  # noqa: E731
    data = {"Di": Di, "Winv": gram_pinv(Di), "mask": shard_rows(mrow, W),
            "aux": (pad(ells).reshape(Bn, W, mw), shard_rows(mrow, W),
                    torch.full((W, mw), float(C), dtype=dtype, device=device))}

    gen = torch.Generator().manual_seed(int(seed))
    drawn = [torch.rand((Bn, k), generator=gen, dtype=torch.float64).to(device=device,
                                                                       dtype=dtype)
             for k in (n, mp, mp)]
    if x0 is None:
        x0 = drawn[0]
    else:
        x0 = as_tensor(x0).to(device=device, dtype=dtype)
        if tuple(x0.shape) != (Bn, n):
            raise ValueError(f"x0 must have shape {(Bn, n)}; got {tuple(x0.shape)}")

    def row_state(v0, drawn_v, name):
        if v0 is None:
            return drawn_v.reshape(Bn, W, mw)
        v0 = as_tensor(v0).to(device=device, dtype=dtype)
        if tuple(v0.shape) != (Bn, m):
            raise ValueError(f"{name} must have shape {(Bn, m)}; got {tuple(v0.shape)}")
        return pad(v0).reshape(Bn, W, mw)

    z0, u0 = row_state(z0, drawn[1], "z0"), row_state(u0, drawn[2], "u0")
    dims = {"Di": None, "Winv": None, "mask": None, "aux": (0, None, None)}
    lay = mesh.lane_layout(Bn, W)
    rows, cols = lay.lanes, lay.shards
    aux = data["aux"]
    data = {"Di": Di[cols], "Winv": data["Winv"], "mask": data["mask"][cols],
            "aux": (aux[0][rows][:, cols], aux[1][cols], aux[2][cols])}
    sync(device)
    t0 = time.perf_counter()
    out = _unwrapped_solve(prox, obj, _svm_obj_global, cfg, m, data, x0[rows],
                           z0[rows][:, cols], u0[rows][:, cols], data_dims=dims,
                           mesh=lay.inner, agree=lay.agree)
    sync(device)
    runtime = time.perf_counter() - t0
    out = gather_lanes(mesh, lay, out, sharded=("zopt", "uopt"))
    return BatchResults(xopt=out["xopt"], zopt=out["zopt"], uopt=out["uopt"],
                        steps=out["steps"], objopt=out["objopt"], rho_final=out["rho_final"],
                        runtime=runtime, hist=out["hist"],
                        extra={"stalled": out["stalled"], "nshards": W, "mesh": mesh})
