"""Per-solver timing and f32 accuracy matrix on the card (port of
``admm_tpu/benchmarks/matrix.py``'s single-device rows).

Two tables, with ``admm_tpu``'s row names, shapes and step counts:

  * TIMING: ADMM iterations per second of every single-device row
    (``domaxiters``, a fixed step count; the solve's loop time, measured on
    the host clock between two ``torch.cuda.synchronize`` calls by the
    engine, best of 3 after a warm-up: ``benchmarks/timing.best_of``).
    Every row carries ``bound_ms_per_iter``, the least time the card could
    take for one step's work, and ``bound_by``: the larger of the bytes a
    step must stream over the H100's 3.35 TB/s and its operations over
    67 TFLOP/s in f32 (989 TFLOP/s for bf16 passes), from a byte and
    operation model written beside each row.  On the card a row gets
    ``pct_of_roofline`` = bound over measured time, except where its bytes
    bound it and fit in the card's L2 cache
    (``torch.cuda.get_device_properties().L2_cache_size``): such a row is
    not held by HBM's rate and could read over 100%, so it carries
    ``roofline_note: "l2-resident; % n/a"`` instead.  Rows with a GEMV
    chain also carry the rate of an eager loop of that chain with the
    engine's bookkeeping tail (``bare_loop_iter_s``, on the card only).
    The sharded rows (``linearsvm_sharded8``, ``svm_batch_sharded``,
    ``consensus_*``, ``sdp_dense_sharded8``, ``exchange_W*``) run their W
    shards stacked on the one device (``parallel.make_mesh``), as
    ``admm_tpu``'s matrix runs them on one chip.
  * ACCURACY: each randomized oracle tester (``testers/problems``) in f32
    on the device against ``_F32_ERRTOL``, and the beyond-reference
    oracles (truths on the host in f64).

Differences from ``admm_tpu``'s matrix: the square D of the LP and
standard-QP timing rows is cut to its first n/2 rows (the square
instance diverges at step 1 in f32; its run is recorded beside the row as
``square_D``); the tunnel's machinery (a control program, the dispatch
floor, ``marginal_iter_s``, ``contention_idx``) is not ported, there is no
tunnel to correct for; rates are not rounded.

Run:  python -m admm_tpu_torch matrix [--smoke] [--device cpu] [--out F]
[--steps N] [--rows NAME,...] (default ``BENCH_MATRIX_TORCH.json``; ``--steps``
caps every row's timed steps, ``--rows`` runs the named rows alone).
Prints one JSON line per row.
"""

from __future__ import annotations

import dataclasses
import json
import subprocess
import time
from pathlib import Path
from typing import Any, Callable, Optional

import numpy as np
import torch

from .timing import best_of

# The H100 SXM's data-sheet peaks (chip_smoke.py's bounds use the same).
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS_PER_S = 67e12
BF16_FLOPS_PER_S = 989e12
L2_NOTE = "l2-resident; % n/a"
# Operation counts of the dense factorizations in the byte and operation
# models (Golub and Van Loan): a symmetric eigendecomposition with vectors
# ~9 n^3, an SVD with both factors ~21 n^3.
EIGH_FLOPS = 9
SVD_FLOPS = 21


def bound_ms(nbytes, flops, peak=F32_FLOPS_PER_S):
    """``(ms, by)``: the larger of ``nbytes`` over the card's memory rate
    and ``flops`` over ``peak``, and which of the two it is."""
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / peak
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def _host(v):
    return v.detach().cpu().numpy() if isinstance(v, torch.Tensor) else np.asarray(v)


@dataclasses.dataclass
class Row:
    """One timing row: ``solve(steps)`` runs it once and returns its results;
    ``nbytes`` and ``flops`` are one step's work (``peak`` the rate its
    operations run at); ``lanes`` the instances it solves at once."""

    name: str
    shape: str = ""
    iters: int = 0
    solve: Optional[Callable] = None
    nbytes: float = 0.0
    flops: float = 0.0
    peak: float = F32_FLOPS_PER_S
    lanes: int = 0
    floor_chain: Any = None
    extra: Optional[Callable] = None  # (steps) -> dict of fields the row adds


def _row(name, shape, iters, res, nbytes=0.0, flops=0.0, peak=F32_FLOPS_PER_S, l2_bytes=None,
         on_card=False, lanes=0, bare=None, extra=None):
    """The row's JSON object (``admm_tpu``'s ``_row`` with the card's
    bound).  Throughput is billed to the steps that ran: a row that stops
    early (nanguard) reads ``valid: false``; lanes bill their slowest."""
    steps_arr = _host(res.steps)
    steps = int(steps_arr.max()) if steps_arr.ndim else int(steps_arr)
    finite = bool(np.all(np.isfinite(_host(res.xopt))))
    ips = max(steps, 1) / res.runtime
    out = {"solver": name, "shape": shape, "iters": iters, "iters_per_sec": ips,
           "ms_per_iter": 1e3 / ips, "wall_ms": res.runtime * 1e3}
    if lanes:
        out["inst_iters_per_sec"] = lanes * iters / res.runtime
    if steps != iters or not finite:
        out.update(valid=False, steps_ran=steps, finite=finite)
    bnd, by = bound_ms(nbytes, flops, peak)
    out.update(bytes_per_iter=nbytes, flops_per_iter=flops, bound_ms_per_iter=bnd,
               bound_by=by)
    if by == "bytes" and l2_bytes is not None and nbytes <= l2_bytes:
        out["roofline_note"] = L2_NOTE
    elif on_card:
        out["pct_of_roofline"] = 100.0 * bnd / out["ms_per_iter"]
    if bare is not None:
        out["bare_loop_iter_s"] = bare
        out["pct_of_bare_loop"] = 100.0 * ips / bare
        pct = out.get("pct_of_roofline")
        out["floor_class"] = ("hbm-bound" if pct is not None and pct >= 50.0 else
                              "device-floor" if out["pct_of_bare_loop"] >= 70.0 else "gap")
    if extra:
        out.update(extra)
    print(json.dumps(out), flush=True)
    return out


def _bare_loop_ips(chain, iters, device, reps=3):
    """Iterations per second of an eager loop of the chained GEMVs of
    ``chain`` ((p, q) stages; the last must produce the first's q) with the
    engine's bookkeeping tail: four residual-norm reductions written to
    four history slots, and the step counter; the iterate renormalized.
    ``admm_tpu``'s bare ``while_loop`` floor, run the way the port runs a
    step (one launch per op), best of ``reps`` after a warm-up."""
    rng = np.random.default_rng(7)
    mats = [torch.as_tensor((rng.standard_normal(s) / np.sqrt(s[-1])).astype(np.float32),
                            device=device) for s in chain]
    x0 = torch.ones(chain[0][-1], dtype=torch.float32, device=device)
    hist = torch.zeros((4, iters), dtype=torch.float32, device=device)

    def run():
        x, xprev = x0, x0
        for k in range(iters):
            for M in mats:
                x = M @ x
            pnorm = torch.linalg.vector_norm(x)
            dnorm = torch.linalg.vector_norm(x - xprev)
            perr = 1e-5 + 1e-3 * torch.maximum(pnorm, x.abs().max())
            derr = 1e-5 + 1e-3 * x.abs().sum()
            hist[:, k] = torch.stack((pnorm, dnorm, perr, derr))
            xprev, x = x, x * torch.rsqrt(torch.mean(x * x) + 1.0)
        return x

    def timed():
        _sync(device)
        t0 = time.perf_counter()
        run()
        _sync(device)
        return time.perf_counter() - t0

    timed()
    return iters / min(timed() for _ in range(reps))


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def timing_rows(smoke=False, device="cpu"):
    """The timing rows in ``admm_tpu``'s order, with their data drawn in
    numpy from ``admm_tpu``'s seed and sequence (so a row holds the same
    instance there and here, but the LP and standard QP, which take the
    first n/2 rows of the same D); nothing is solved until a row's
    ``solve`` runs."""
    from .. import (ADMMConfig, basispursuit, basispursuit_batch, covarianceselection,
                    covsel_batch, huberfit, lad, lasso, lasso_batch, lasso_path, linearprogram,
                    linearsvm, logreg, logreg_batch, model, qp_batch, quadraticprogram,
                    quantile, rpca, sdp_batch, svm_batch, totalvariation, tv_batch)
    from ..models.sdp import random_sdp_instance, sdp
    from ..parallel import (consensus_covsel, consensus_lasso, consensus_lasso_batch,
                            exchange_quadratic, linearsvm_sharded, make_mesh2d, sdp_sharded,
                            svm_batch_sharded)

    device = torch.device(device)
    on = lambda a: torch.as_tensor(a, device=device)  # noqa: E731  (per solve, outside its loop)
    rng = np.random.default_rng(0)
    f32 = np.float32
    bf16 = torch.bfloat16
    sc = 4 if smoke else 1  # smoke: shapes 4x smaller, steps 10x fewer
    it = lambda n: max(n // (10 if smoke else 1), 10)  # noqa: E731
    rows = []

    def cfg(iters, unroll="auto", **kw):
        return ADMMConfig(maxiters=iters, domaxiters=True, unroll=unroll, **kw)

    def add(*a, **kw):
        rows.append(Row(*a, **kw))

    # admm_tpu's contention control draws its data first (not run here).
    mc, nc = 1500 // sc, 5000 // sc
    rng.standard_normal((mc, nc))
    rng.standard_normal(nc)
    rng.random(nc)

    # --- model: two dense n-by-n inverse applies per iteration ----------
    n = 2048 // sc
    P, Q = rng.standard_normal((n, n)).astype(f32), rng.standard_normal((n, n)).astype(f32)
    r, s = rng.standard_normal(n).astype(f32), rng.standard_normal(n).astype(f32)
    iters = it(8000)
    add("model", f"{n}x{n}", iters,
        lambda i, P=P, Q=Q, r=r, s=s: model(on(P), on(Q), on(r), on(s), cfg(i)),
        2 * n * n * 4, 4 * n * n, floor_chain=((n, n), (n, n)))

    # --- lasso fat (headline): f32 / fused kernel (K1b) / bf16 streams (K2)
    m, n = 1500 // sc, 5000 // sc
    testx = rng.standard_normal(n) * (rng.random(n) < 0.1)
    D = rng.standard_normal((m, n)).astype(f32)
    D /= np.sqrt(np.sum(D**2, axis=0, keepdims=True))
    sv = (D @ testx + 0.03 * rng.standard_normal(m)).astype(f32)
    lam = float(0.1 * np.max(np.abs(D.T @ sv)))
    iters = it(2000)
    streams = 2 * m * n  # FatShiftSolver: two m-by-n GEMV streams
    for name, unroll, kw, item in (
            ("lasso_fat_f32_unroll1", 1, {}, 4),
            ("lasso_fat_f32", "auto", {}, 4),
            ("lasso_fat_f32_fusedkernel", "auto", dict(use_fused_kernel=True), 4),
            ("lasso_fat_bf16streams", "auto", dict(stream_dtype=bf16), 2),
            ("lasso_fat_bf16_fusedkernel", "auto", dict(stream_dtype=bf16,
                                                        use_fused_kernel=True), 2)):
        add(name, f"{m}x{n}", iters,
            lambda i, kw=kw, u=unroll: lasso(on(D), on(sv), lam, cfg(i, unroll=u), **kw),
            streams * item, 2 * streams)

    # --- lasso skinny: one n-by-n inverse apply -------------------------
    m, n = 4096 // sc, 1024 // sc
    D2 = rng.standard_normal((m, n)).astype(f32)
    s2 = rng.standard_normal(m).astype(f32)
    iters = it(8000)
    add("lasso_skinny_f32", f"{m}x{n}", iters,
        lambda i: lasso(on(D2), on(s2), 0.1, cfg(i)), n * n * 4, 2 * n * n,
        floor_chain=((n, n),))

    # --- basis pursuit: projection P (n x n) apply ----------------------
    m, n = 512 // sc, 2048 // sc
    D3 = rng.standard_normal((m, n)).astype(f32)
    x3 = rng.standard_normal(n) * (rng.random(n) < 0.1)
    s3 = (D3 @ x3).astype(f32)
    iters = it(8000)
    add("basispursuit_f32", f"{m}x{n}", iters,
        lambda i: basispursuit(on(D3), on(s3), cfg(i)), n * n * 4, 2 * n * n,
        floor_chain=((n, n),))

    # --- total variation: dense vs cyclic reduction (K4) ----------------
    for n, solver, iters in ((2048 // sc, "dense", it(8000)), (8192 // sc, "dense", it(500)),
                             (8192 // sc, "cr", it(2000)),
                             (65536, "cr", it(1000)) if not smoke else (16384, "cr", it(1000))):
        stair = np.repeat(rng.standard_normal(max(n // 64, 1)), 64)[:n]
        sig = (stair + 0.5 * rng.standard_normal(n)).astype(f32)
        # dense: the n-by-n inverse streamed; cr: x, z, u read and written
        # and s read once (the solve's own traffic is below that).
        nbytes = n * n * 4 if solver == "dense" else 7 * n * 4
        add(f"totalvariation_{solver}", f"n={n}", iters,
            lambda i, sig=sig, solver=solver:
            totalvariation(on(sig), 0.5, cfg(i), solver=solver),
            nbytes, 2 * n * n if solver == "dense" else 0)

    # --- lad / huberfit / quantile: cached normal-equations solve -------
    m, n = 4096 // sc, 512 // sc
    D4 = rng.standard_normal((m, n)).astype(f32)
    s4 = rng.standard_normal(m).astype(f32)
    iters = it(8000)
    ne = (n * n + 2 * m * n)
    for name, fn in (("lad_f32", lad), ("huberfit_f32", huberfit)):
        add(name, f"{m}x{n}", iters, lambda i, fn=fn: fn(on(D4), on(s4), cfg(i)),
            ne * 4, 2 * ne, floor_chain=((n, m), (m, n)))

    # --- LP / QP: folded static-KKT paths -------------------------------
    n = 1024 // sc
    truex = np.abs(rng.standard_normal(n))
    Dlp_sq = np.abs(rng.standard_normal((n, n))).astype(f32)
    slp_sq = (Dlp_sq @ truex).astype(f32)
    blp = (rng.random(n) + 0.5).astype(f32)
    # The square D diverges at step 1 in f32; the rows time its first n/2
    # rows and record the square instance's own run beside them.
    Dlp, slp = Dlp_sq[: n // 2], (Dlp_sq[: n // 2] @ truex).astype(f32)
    iters = it(16000)

    def square(solve, half=n // 2):
        def extra(i):
            res = solve(i)
            return {"D_rows": half, "square_D": {
                "steps_ran": int(_host(res.steps)), "diverged": bool(res.diverged),
                "finite": bool(np.all(np.isfinite(_host(res.xopt))))}}
        return extra

    add("linearprogram_f32", f"n={n}", iters,
        lambda i: linearprogram(on(blp), on(Dlp), on(slp), cfg(i)), n * n * 4, 2 * n * n,
        floor_chain=((n, n),),
        extra=square(lambda i: linearprogram(on(blp), on(Dlp_sq), on(slp_sq), cfg(i))))
    add("linearprogram_chol_f32", f"n={n}", iters,
        lambda i: linearprogram(on(blp), on(Dlp), on(slp), cfg(i, unroll=1),
                                      kkt_mode="chol"),
        3 * n * n * 4, 6 * n * n, extra=lambda i, half=n // 2: {"D_rows": half})

    Pq = rng.standard_normal((n, n)).astype(f32)
    Pq = (Pq @ Pq.T + n * np.eye(n)).astype(f32)
    qv = rng.standard_normal(n).astype(f32)
    Dqp_sq = (rng.standard_normal((n, n)) / np.sqrt(n)).astype(f32)
    sqp_sq = (Dqp_sq @ truex).astype(f32)
    Dqp, sqp = Dqp_sq[: n // 2], (Dqp_sq[: n // 2] @ truex).astype(f32)
    add("quadraticprogram_standard_f32", f"n={n}", iters,
        lambda i: quadraticprogram(on(Pq), on(qv), 0.0, on(Dqp), on(sqp), cfg(i)),
        n * n * 4, 2 * n * n, floor_chain=((n, n),),
        extra=square(lambda i: quadraticprogram(on(Pq), on(qv), 0.0, on(Dqp_sq),
                                                      on(sqp_sq), cfg(i))))

    n2 = 2048 // sc
    Pb = rng.standard_normal((n2, n2)).astype(f32)
    Pb = (Pb @ Pb.T + n2 * np.eye(n2)).astype(f32)
    qb = rng.standard_normal(n2).astype(f32)
    lb, ub = -np.ones(n2, f32), np.ones(n2, f32)
    iters2 = it(8000)
    add("quadraticprogram_bounded_f32", f"n={n2}", iters2,
        lambda i: quadraticprogram(on(Pb), on(qb), 0.0, on(lb), on(ub), cfg(i)),
        n2 * n2 * 4, 2 * n2 * n2)

    # --- covariance selection: eigh vs Newton-Schulz --------------------
    def covsel_row(name, A, iters, n, pm, ns_iters):
        kw = {} if pm == "eigh" else dict(prox_method=pm, **({"ns_iters": ns_iters}
                                                            if ns_iters != 20 else {}))
        flops = ((EIGH_FLOPS + 2) * n**3 if pm == "eigh" else ns_iters * 6 * n**3)
        add(name, f"n={n}", iters,
            lambda i, kw=kw: covarianceselection(on(A), 0.1, cfg(i), **kw),
            2 * n * n * 4, flops, BF16_FLOPS_PER_S if pm == "ns_fast" else F32_FLOPS_PER_S)

    n = 256 // sc
    A = rng.standard_normal((4 * n, n)).astype(f32)
    iters = it(200)
    covsel_row("covarianceselection_f32", A, iters, n, "eigh", 20)
    covsel_row("covarianceselection_ns_f32", A, iters, n, "ns", 20)
    n = 512 // sc
    A = rng.standard_normal((4 * n, n)).astype(f32)
    covsel_row("covarianceselection_ns_f32", A, iters, n, "ns", 20)
    covsel_row("covarianceselection_nsfast_f32", A, iters, n, "ns_fast", 14)
    if not smoke:
        n = 1024
        A = rng.standard_normal((4 * n, n)).astype(f32)
        iters = it(100)
        covsel_row("covarianceselection_ns_f32", A, iters, n, "ns", 14)
        covsel_row("covarianceselection_nsfast_f32", A, iters, n, "ns_fast", 14)

    # --- quantile regression: LAD's body with the asymmetric threshold --
    m, n = 4096 // sc, 512 // sc
    Dq5 = rng.standard_normal((m, n)).astype(f32)
    s5 = rng.standard_normal(m).astype(f32)
    iters = it(8000)
    ne = (n * n + 2 * m * n)
    add("quantile_f32", f"{m}x{n}", iters,
        lambda i: quantile(on(Dq5), on(s5), 0.8, cfg(i)), ne * 4, 2 * ne,
        floor_chain=((n, m), (m, n)))

    # --- robust PCA: one SVD per iteration ------------------------------
    nr = 256 // sc
    Lr = (rng.standard_normal((nr, 8)) @ rng.standard_normal((8, nr))).astype(f32)
    Sr = ((rng.random((nr, nr)) < 0.05) * 5 * rng.standard_normal((nr, nr))).astype(f32)
    M = Lr + Sr
    iters = it(200)
    add("rpca_f32", f"{nr}x{nr}", iters, lambda i: rpca(on(M), config=cfg(i)),
        3 * nr * nr * 4, SVD_FLOPS * nr**3)
    # rsvd, rank 16 + 10 oversampling, 2 power iterations: 6 passes over M.
    add("rpca_rsvd16_f32", f"{nr}x{nr}", iters,
        lambda i: rpca(on(M), config=cfg(i), prox_method="rsvd", rank=16),
        6 * nr * nr * 4, 6 * 2 * nr * nr * 26)

    # --- sparse logistic regression: Newton x-prox in the loop ----------
    m, n = 4096 // sc, 256 // sc
    Dlr = rng.standard_normal((m, n)).astype(f32)
    wlr = rng.standard_normal(n)
    plr = 1.0 / (1.0 + np.exp(-(Dlr @ wlr)))
    ylr = np.where(rng.random(m) < plr, 1.0, -1.0).astype(f32)
    iters = it(200)
    newton = 5 * (2 * m * n * n + n**3 / 3)  # 5 Hessians D^T W D and Choleskys
    add("logreg_f32", f"{m}x{n}", iters, lambda i: logreg(on(Dlr), on(ylr), 0.1, cfg(i)),
        m * n * 4, newton)
    y8 = rng.integers(0, 8, size=m)
    ell8 = np.stack([np.where(y8 == k, 1.0, -1.0) for k in range(8)]).astype(f32)
    # Newton-CG, 4 x 12 PCG steps, each two matvecs with D shared by lanes.
    add("logreg_batch_B8_cg", f"{m}x{n}", iters,
        lambda i: logreg_batch(on(Dlr), on(ell8), 0.1, cfg(i)),
        4 * 12 * 2 * m * n * 4, 8 * 4 * 12 * 2 * 2 * m * n, lanes=8)
    add("logreg_batch_B8_dense", f"{m}x{n}", iters,
        lambda i: logreg_batch(on(Dlr), on(ell8), 0.1, cfg(i), inner="newton"),
        m * n * 4, 8 * newton, lanes=8)

    # --- linear SVM: serial and 8-shard transpose reduction ------------
    m, n = 4096 // sc, 512 // sc
    Dsvm = rng.standard_normal((m, n)).astype(f32)
    w0 = rng.standard_normal(n)
    ell = np.sign(Dsvm @ w0 + 0.1 * rng.standard_normal(m)).astype(f32)
    iters = it(8000)
    add("linearsvm_serial_f32", f"{m}x{n}", iters,
        lambda i: linearsvm(on(Dsvm), on(ell), 1.0, cfg(i)), 2 * m * n * 4, 4 * m * n,
        floor_chain=((n, m), (m, n)))
    # Transpose reduction: D_i^T (z_i - u_i) and D_i x over the stacked
    # shards, and the n-by-n W^+ apply.
    tr = 2 * m * n + n * n
    add("linearsvm_sharded8_f32", f"{m}x{n}", iters,
        lambda i: linearsvm_sharded(on(Dsvm), on(ell), 1.0, cfg(i), nshards=8),
        tr * 4, 2 * tr)
    y10 = rng.integers(0, 10, size=m)
    ells = np.stack([np.where(y10 == k, 1.0, -1.0) for k in range(10)]).astype(f32)
    add("svm_batch_B10_onevsall", f"{m}x{n}", iters,
        lambda i: svm_batch(on(Dsvm), on(ells), 1.0, cfg(i)),
        2 * m * n * 4, 10 * 4 * m * n, lanes=10)
    add("svm_batch_sharded_B10x8shard", f"{m}x{n}", iters,
        lambda i: svm_batch_sharded(on(Dsvm), on(ells), 1.0, cfg(i),
                                    mesh=make_mesh2d(1, 1, device=device), nshards=8),
        tr * 4, 10 * 2 * tr, lanes=10)
    # Consensus: fixed total rows, W in {1, 2, 4, 8}; a step streams the
    # W stacked n-by-n Minv once (the consensus math beside it is O(W n)).
    for Wsh in (1, 2, 4, 8):
        add(f"consensus_lasso_{Wsh}shard_f32", f"{m}x{n}", iters,
            lambda i, Wsh=Wsh: consensus_lasso(on(Dsvm), on(s4), 0.1, cfg(i), nshards=Wsh),
            Wsh * n * n * 4, 2 * Wsh * n * n)
    S8 = np.stack([s4 + 0.01 * k for k in range(8)]).astype(f32)
    add("consensus_lasso_batch_B8x8shard", f"{m}x{n}", iters,
        lambda i: consensus_lasso_batch(on(Dsvm), on(S8), 0.1, cfg(i),
                                        mesh=make_mesh2d(1, 1, device=device), nshards=8),
        8 * n * n * 4, 8 * 2 * 8 * n * n, lanes=8)
    # dvaltol=0 keeps the accelerated d-value stop (which ignores
    # domaxiters) from ending the row early.
    add("consensus_lasso_8shard_fast_f32", f"{m}x{n}", iters,
        lambda i: consensus_lasso(on(Dsvm), on(s4), 0.1, cfg(i, fast=True, dvaltol=0.0),
                                  nshards=8),
        8 * n * n * 4, 2 * 8 * n * n)

    # --- lanes: a path of B lambdas, B signals, B decodes, B QPs --------
    m, n, B = 1500 // sc, 5000 // sc, 128
    Dp = rng.standard_normal((m, n)).astype(f32)
    Dp /= np.sqrt(np.sum(Dp**2, axis=0, keepdims=True))
    sp = (Dp @ (rng.standard_normal(n) * (rng.random(n) < 0.1))).astype(f32)
    lmax = float(np.max(np.abs(Dp.T @ sp)))
    lams = np.geomspace(0.001 * lmax, 0.5 * lmax, B).astype(f32)
    iters = it(300)
    for tag, kw, peak in (("highest", {}, F32_FLOPS_PER_S),
                          ("bf16pass", {"matmul_precision": "default"}, BF16_FLOPS_PER_S)):
        add(f"lasso_path_B{B}_{tag}", f"{m}x{n}", iters,
            lambda i, kw=kw: lasso_path(on(Dp), on(sp), on(lams), cfg(i), **kw),
            2 * m * n * 4, B * 4 * m * n, peak, lanes=B)
    Xb = (rng.standard_normal((B, n)) * (rng.random((B, n)) < 0.1)).astype(f32)
    Sb = (Xb @ Dp.T + 0.03 * rng.standard_normal((B, m))).astype(f32)
    lamb = float(0.1 * np.median(np.max(np.abs(Sb @ Dp), axis=1)))
    add(f"lasso_batch_B{B}", f"{m}x{n}", iters,
        lambda i: lasso_batch(on(Dp), on(Sb), lamb, cfg(i)),
        2 * m * n * 4, B * 4 * m * n, lanes=B)
    ntv = 8192 // sc
    Sig = np.cumsum(rng.standard_normal((B, ntv)), axis=1).astype(f32)
    add(f"tv_batch_B{B}_cr", f"n={ntv}", iters,
        lambda i: tv_batch(on(Sig), 1.0, cfg(i), solver="cr"), 7 * B * ntv * 4, 0,
        lanes=B)
    mbp, nbp = 512 // sc, 2048 // sc
    Dbp = rng.standard_normal((mbp, nbp)).astype(f32)
    Xbp = (rng.standard_normal((B, nbp)) * (rng.random((B, nbp)) < 0.05))
    Sbp = (Xbp @ Dbp.T).astype(f32)
    add(f"basispursuit_batch_B{B}", f"{mbp}x{nbp}", iters,
        lambda i: basispursuit_batch(on(Dbp), on(Sbp), cfg(i)),
        nbp * nbp * 4, B * 2 * nbp * nbp, lanes=B)
    nq, mq, Bq = 1024 // sc, 256 // sc, 64
    Rq = rng.standard_normal((nq, 2 * nq)).astype(f32)
    Pq2 = (Rq @ Rq.T / (2 * nq) + 0.1 * np.eye(nq)).astype(f32)
    Dq = rng.standard_normal((mq, nq)).astype(f32)
    Ssq = (np.abs(rng.standard_normal((Bq, nq))) @ Dq.T).astype(f32)
    Qsq = rng.standard_normal((Bq, nq)).astype(f32)
    itq = it(1000)
    add(f"qp_batch_B{Bq}_standard", f"n={nq}", itq,
        lambda i: qp_batch(on(Pq2), on(Qsq), 0.0, on(Dq), on(Ssq), cfg(i)),
        nq * nq * 4, Bq * 2 * nq * nq, lanes=Bq)
    Bc, ncv = 32, max(2, 128 // sc)
    Zc = rng.standard_normal((Bc, ncv, 4 * ncv)).astype(f32)
    Sc = (Zc @ np.swapaxes(Zc, 1, 2) / (4 * ncv) + 0.1 * np.eye(ncv, dtype=f32)).astype(f32)
    itc = it(200)
    add(f"covsel_batch_B{Bc}_ns", f"n={ncv}", itc,
        lambda i: covsel_batch(on(Sc), 0.05, cfg(i)),
        2 * Bc * ncv * ncv * 4, Bc * 20 * 6 * ncv**3, lanes=Bc)
    add(f"covsel_batch_B{Bc}_nsfast", f"n={ncv}", itc,
        lambda i: covsel_batch(on(Sc), 0.05, cfg(i), prox_method="ns_fast", ns_iters=14),
        2 * Bc * ncv * ncv * 4, Bc * 14 * 6 * ncv**3, BF16_FLOPS_PER_S, lanes=Bc)

    def sdp_rows(Bs, nsd, its, Lap, batched):
        ones = np.ones(nsd, f32)
        C = (-0.25 * Lap).astype(f32)
        for pm in ("eigh", "ns"):
            kw = {} if pm == "eigh" else {"prox_method": "ns", "ns_iters": 16}
            flops = Bs * ((EIGH_FLOPS + 2) * nsd**3 if pm == "eigh" else 16 * 6 * nsd**3)
            if batched:
                add(f"sdp_batch_B{Bs}_{pm}", f"n={nsd}", its,
                    lambda i, kw=kw: sdp_batch(on(C), "diag", on(ones), cfg(i), **kw),
                    2 * Bs * nsd * nsd * 4, flops, lanes=Bs)
            else:
                add(f"sdp_serial_{pm}", f"n={nsd}", its,
                    lambda i, kw=kw: sdp(on(C[0]), "diag", on(ones), config=cfg(i), **kw),
                    2 * nsd * nsd * 4, flops)

    Bs, nsd = 16, max(2, 128 // sc)
    Wadj = (rng.random((Bs, nsd, nsd)) < 0.1).astype(f32)
    Wadj = np.triu(Wadj, 1)
    Wadj = Wadj + np.swapaxes(Wadj, 1, 2)
    Lap = (np.stack([np.diag(Wadj[i].sum(-1)) for i in range(Bs)]) - Wadj).astype(f32)
    sdp_rows(Bs, nsd, it(100), Lap, True)
    for Bs2, ns2, its2 in ((4, 256 // sc, it(60)), (1, 512 // sc, it(40))):
        Wadj2 = (rng.random((max(Bs2, 1), ns2, ns2)) < 0.1).astype(f32)
        Wadj2 = np.triu(Wadj2, 1)
        Wadj2 = Wadj2 + np.swapaxes(Wadj2, 1, 2)
        Lap2 = (np.stack([np.diag(Wadj2[i].sum(-1)) for i in range(max(Bs2, 1))])
                - Wadj2).astype(f32)
        sdp_rows(Bs2, ns2, its2, Lap2, Bs2 > 1)

    nsd3, msd3 = 128 // sc, 512 // sc
    Csd3, Asd3, bsd3, *_ = random_sdp_instance(nsd3, msd3, nsd3 // 4, rng, dtype=f32)
    its3 = it(100)
    # The affine projection reads the (m, n, n) stack twice (A and A^T).
    add("sdp_dense_serial", f"n={nsd3} m={msd3}", its3,
        lambda i: sdp(on(Csd3), on(Asd3), on(bsd3), config=cfg(i)),
        2 * msd3 * nsd3 * nsd3 * 4, 4 * msd3 * nsd3 * nsd3 + (EIGH_FLOPS + 2) * nsd3**3)
    add("sdp_dense_sharded8", f"n={nsd3} m={msd3}", its3,
        lambda i: sdp_sharded(on(Csd3), on(Asd3), on(bsd3), config=cfg(i), nshards=8),
        2 * msd3 * nsd3 * nsd3 * 4, 4 * msd3 * nsd3 * nsd3 + (EIGH_FLOPS + 2) * nsd3**3)

    # --- consensus covariance selection: 8 per-shard spectral proxes ----
    # A step reads and writes the 8 stacked p-by-p S_i, x_i, u_i.
    pcv, mcv = 256 // sc, 4096 // sc
    Dcv = rng.standard_normal((mcv, pcv)).astype(f32)
    itcv = it(200)
    add("consensus_covsel_8shard_eigh", f"p={pcv}", itcv,
        lambda i: consensus_covsel(on(Dcv), 0.1, cfg(i), nshards=8),
        8 * 5 * pcv * pcv * 4, 8 * (EIGH_FLOPS + 4) * pcv**3)
    add("consensus_covsel_8shard_ns", f"p={pcv}", itcv,
        lambda i: consensus_covsel(on(Dcv), 0.1, cfg(i), nshards=8, prox_method="ns",
                                   ns_iters=14),
        8 * 5 * pcv * pcv * 4, 8 * (14 * 6 + 4) * pcv**3)

    # --- exchange: W = 8 quadratic agents; a step reads the (W, n, n)
    # eigenvector stack twice.
    Wx, mx, nx = 8, 512 // sc, 256 // sc
    Ax = rng.standard_normal((Wx, mx, nx)).astype(f32)
    bx = rng.standard_normal((Wx, mx)).astype(f32)
    itx = it(16000)
    add(f"exchange_W{Wx}", f"{mx}x{nx}", itx,
        lambda i: exchange_quadratic(on(Ax), on(bx), cfg(i)),
        2 * Wx * nx * nx * 4, 4 * Wx * nx * nx)
    return rows


def timing_matrix(smoke=False, device="cuda", steps=None, only=None):
    """Run the timing rows on ``device``; returns their JSON objects.

    ``steps`` caps every row's step count (the row then records
    ``matrix_iters``, the count it was cut from); ``only``, a set of row
    names, runs those rows alone."""
    device = torch.device(device)
    rows = timing_rows(smoke, device)
    on_card = device.type == "cuda"
    l2 = torch.cuda.get_device_properties(device).L2_cache_size if on_card else None
    out = []
    for row in rows:
        if only is not None and row.name not in only:
            continue
        iters = row.iters if steps is None else min(row.iters, steps)
        res = best_of(lambda: row.solve(iters))
        bare = (_bare_loop_ips(row.floor_chain, min(4000, iters), device)
                if row.floor_chain is not None and on_card else None)
        extra = {"device": str(device)}
        if iters != row.iters:
            extra["matrix_iters"] = row.iters
        if row.extra is not None:
            extra.update(row.extra(iters))
        out.append(_row(row.name, row.shape, iters, res, row.nbytes, row.flops, row.peak, l2,
                        on_card, row.lanes, bare, extra))
    return out



# f32-appropriate oracle tolerances (admm_tpu's, unchanged: a bar that
# fails on the card is a fault to record, never a bar to loosen).
_F32_ERRTOL = {
    "model": 2e-3,
    "lasso": 1e-3,
    "basispursuit": 1e-4,     # f64 bar 1e-10 is below the f32 floor
    "totalvariation": 0.02,
    "lad": 1e-2,
    "huberfit": 1e-3,
    "linearprogram": 1e-4,    # f64 bar 1e-10
    "quadraticprogram": 5e-3,  # x-residual criterion; ~2e-3 is the f32 floor
    "covarianceselection": 1e-3,
    "linearsvm": 0.05,
    # KKT subgradient residual of the nonsmooth optimum at f32.
    "logreg": 5e-3,
}
# admm_tpu's oracle settings: f32-grade Boyd tolerances and the plateau
# detector, so a family whose f32 floor sits above them stops there.
ORACLE = dict(abstol=1e-7, reltol=1e-6, stallwindow=100)


def accuracy_matrix(smoke=False, device="cuda", only=None):
    """Each randomized oracle tester in f32 on ``device`` (truths computed on
    the host in f64 by the testers), then the beyond-reference oracles.
    ``only``, a set of row names, runs those rows alone."""
    from ..testers import problems as p

    device = torch.device(device)
    rows = []
    for name, tester, kw in (
        ("model", p.modeltest, {}),
        ("lasso", p.lassotest, {}),
        ("basispursuit", p.basispursuittest, {}),
        ("totalvariation", p.totalvariationtest, {}),
        ("lad", p.ladtest, {}),
        ("huberfit", p.huberfittest, {}),
        ("linearprogram", p.linearprogramtest, {}),
        ("quadraticprogram", p.quadraticprogramtest, {"form": "standard"}),
        ("quadraticprogram_bounded", p.quadraticprogramtest, {"form": "bounded"}),
        ("covarianceselection", p.covarianceselectiontest, {}),
        ("covarianceselection_ns", p.covarianceselectiontest, {"prox_method": "ns"}),
        ("covarianceselection_nsfast", p.covarianceselectiontest, {"prox_method": "ns_fast"}),
        ("linearsvm", p.linearsvmtest, {}),
        ("logreg", p.logregtest, {}),
        ("logreg_cg", p.logregtest, {"inner": "newton_cg"}),
    ):
        if only is not None and name not in only:
            continue
        errtol = _F32_ERRTOL.get(name.split("_")[0], 1e-3)
        t0 = time.perf_counter()
        out = tester(seed=1, errtol=errtol, quiet=True, device=device, dtype=torch.float32,
                     **ORACLE, **kw)
        dt = time.perf_counter() - t0
        test, res = out[-1], out[0]
        row = {"solver": name, "f32_errtol": errtol, "failed": bool(test["failed"]),
               "steps": int(_host(res.steps)), "stalled": bool(res.stalled), "wall_s": dt}
        for k in ("objerror", "xresidual", "relerror", "objopt", "trueobjopt", "relerr_hinge",
                  "relerr_01", "failreason"):
            v = test.get(k)
            if v is not None and not isinstance(v, (np.ndarray, torch.Tensor)):
                row[k] = float(v) if isinstance(v, (int, float, np.floating)) else v
        print(json.dumps(row), flush=True)
        rows.append(row)
    rows.extend(_beyond_reference_accuracy(device, only))
    return rows


def _beyond_reference_accuracy(device, only=None):
    """On-device f32 oracles of the beyond-reference families, truths on
    the host in f64 (``admm_tpu``'s)."""
    from scipy.optimize import linprog

    from .. import (ADMMConfig, elasticnet, fusedlasso, grouplasso, linearprogram, nnls,
                    quantile, rpca)
    from ..models.sdp import random_sdp_instance, sdp
    from ..parallel import exchange_quadratic

    rng = np.random.default_rng(1)
    f32 = np.float32
    f64 = lambda v: _host(v).astype(np.float64)  # noqa: E731
    cfg = ADMMConfig(maxiters=20000, **ORACLE)
    rows = []

    def emit(name, errtol, err, res, extra=None):
        row = {"solver": name, "f32_errtol": errtol, "failed": bool(not (err <= errtol)),
               "relerror": float(err), "steps": int(_host(res.steps)),
               "stalled": bool(res.stalled)}
        row.update(extra or {})
        print(json.dumps(row), flush=True)
        rows.append(row)

    def want(name):
        return only is None or name in only

    m, n = 192, 96
    D = rng.standard_normal((m, n)).astype(f32)
    xt = rng.standard_normal(n) * (rng.random(n) < 0.4)
    s = (D.astype(np.float64) @ xt + 0.05 * rng.standard_normal(m)).astype(f32)
    D64, s64 = D.astype(np.float64), s.astype(np.float64)

    if want("elasticnet_ridge"):  # alpha = 0: the ridge closed form
        lam = 0.8
        res = elasticnet(D, s, lam, alpha=0.0, config=cfg, device=device)
        xstar = np.linalg.solve(D64.T @ D64 + lam * np.eye(n), D64.T @ s64)
        emit("elasticnet_ridge", 1e-3,
             np.linalg.norm(f64(res.zopt) - xstar) / np.linalg.norm(xstar), res)

    if want("grouplasso_kkt"):  # singleton groups: lasso's KKT conditions
        res = grouplasso(D, s, 0.5, np.arange(n), config=cfg, device=device)
        z = f64(res.zopt)
        g = D64.T @ (D64 @ z - s64)
        act = np.abs(z) > 1e-6
        kkt = max(float(np.max(np.abs(g[act] + 0.5 * np.sign(z[act])))) if act.any() else 0.0,
                  float(max(np.max(np.abs(g[~act])) - 0.5, 0.0)) if (~act).any() else 0.0)
        emit("grouplasso_kkt", 5e-3, kkt, res)

    if want("nnls_kkt"):  # feasibility and the KKT sign conditions
        res = nnls(D, s, config=cfg, device=device)
        z = f64(res.zopt)
        g = D64.T @ (D64 @ z - s64)
        kkt = max(float(np.max(np.abs(g[z > 1e-6]), initial=0.0)),
                  float(max(-np.min(g[z <= 1e-6], initial=0.0), 0.0)),
                  float(max(-np.min(z), 0.0)))
        emit("nnls_kkt", 5e-3, kkt, res)

    if want("quantile_lp_oracle"):  # the objective against scipy's LP
        tau = 0.7
        res = quantile(D, s, tau, cfg, device=device)
        r_ = D64 @ f64(res.xopt) - s
        f_admm = float(np.sum(np.maximum(tau * r_, (tau - 1) * r_)))
        out = linprog(np.r_[np.zeros(n), tau * np.ones(m), (1 - tau) * np.ones(m)],
                      A_eq=np.c_[D64, -np.eye(m), np.eye(m)], b_eq=s64,
                      bounds=[(None, None)] * n + [(0, None)] * (2 * m), method="highs")
        emit("quantile_lp_oracle", 1e-3, abs(f_admm - out.fun) / abs(out.fun), res,
             {"f_lp": float(out.fun)})

    # fusedlasso: lam2 = 0 is the soft-threshold closed form.
    sig = (np.repeat(rng.standard_normal(8), 24) + 0.3 * rng.standard_normal(192)).astype(f32)
    if want("fusedlasso_softthresh"):
        res = fusedlasso(sig, 0.4, 0.0, cfg, device=device)
        truth = np.sign(sig) * np.maximum(np.abs(sig) - 0.4, 0.0)
        emit("fusedlasso_softthresh", 1e-3,
             np.linalg.norm(f64(res.xopt) - truth) / max(np.linalg.norm(truth), 1e-30), res)

    # sdp: the objective gap to the constructed primal-dual optimum.
    C, Asd, bsd, Xstar, _, _ = random_sdp_instance(16, 24, 6, rng, dtype=f32)
    pstar = float(np.sum(C.astype(np.float64) * Xstar.astype(np.float64)))
    for pm, bar in (("eigh", 1e-3), ("ns", 1e-2)):
        if want(f"sdp_gap_{pm}"):
            res = sdp(C, Asd, bsd, config=cfg, prox_method=pm, ns_iters=30, device=device)
            obj = float(np.sum(C.astype(np.float64) * f64(res.zopt)))
            emit(f"sdp_gap_{pm}", bar, abs(obj - pstar) / max(1.0, abs(pstar)), res)

    # exchange: the quadratic market equilibrium (host f64 oracle).
    Wx, mx, nx = 8, 24, 12
    Ax = rng.standard_normal((Wx, mx, nx)).astype(f32)
    bx = rng.standard_normal((Wx, mx)).astype(f32)
    if want("exchange_equilibrium"):
        Ginv = np.stack([np.linalg.inv(A.T @ A) for A in Ax.astype(np.float64)])
        Atb = np.einsum("wmi,wm->wi", Ax.astype(np.float64), bx.astype(np.float64))
        nu = np.linalg.solve(Ginv.sum(0), np.einsum("wij,wj->i", Ginv, Atb))
        xeq = np.einsum("wij,wj->wi", Ginv, Atb - nu[None, :])
        res = exchange_quadratic(Ax, bx, config=cfg, device=device)
        emit("exchange_equilibrium", 1e-3,
             np.linalg.norm(f64(res.xopt) - xeq) / np.linalg.norm(xeq), res)

    # rpca: planted low-rank + sparse recovery.
    nr = 96
    L0 = rng.standard_normal((nr, 4)) @ rng.standard_normal((4, nr))
    S0 = (rng.random((nr, nr)) < 0.05) * (5 * rng.standard_normal((nr, nr)))
    if want("rpca_recovery"):
        res = rpca((L0 + S0).astype(f32), config=ADMMConfig(maxiters=3000, **ORACLE),
                   device=device)
        emit("rpca_recovery", 1e-3, np.linalg.norm(f64(res.xopt) - L0) / np.linalg.norm(L0),
             res)

    # Anderson acceleration on the SDP: KKT gap at tolerances f32 meets.
    Caa, Aaa, baa, Xaa, _, _ = random_sdp_instance(64, 128, 8, np.random.default_rng(7),
                                                   dtype=f32)
    paa = float(np.sum(Caa.astype(np.float64) * Xaa.astype(np.float64)))
    cfg_aa = dict(maxiters=8000, abstol=1e-5, reltol=1e-5, stallwindow=200)
    if want("sdp_gap_eigh_aa10"):
        res_pl = sdp(Caa, Aaa, baa, config=ADMMConfig(**cfg_aa), prox_method="eigh",
                     device=device)
        res = sdp(Caa, Aaa, baa, config=ADMMConfig(anderson=10, **cfg_aa), prox_method="eigh",
                  device=device)
        obj = float(np.sum(Caa.astype(np.float64) * f64(res.zopt)))
        emit("sdp_gap_eigh_aa10", 5e-3, abs(obj - paa) / max(1.0, abs(paa)), res,
             {"steps_plain": int(_host(res_pl.steps))})

    # Ruiz preconditioning on a badly scaled LP, against HiGHS in f64.
    mlp, nlp = 48, 144
    Dlp = rng.standard_normal((mlp, nlp))
    slp = Dlp @ np.abs(rng.standard_normal(nlp))
    blp = np.abs(rng.standard_normal(nlp)) + 0.1
    Glp = 10.0 ** rng.uniform(-2, 2, mlp)
    Flp = 10.0 ** rng.uniform(-2, 2, nlp)
    Dbad = (Glp[:, None] * Dlp * Flp[None, :]).astype(f32)
    sbad = (Glp * slp).astype(f32)
    bbad = (Flp * blp).astype(f32)
    if want("lp_precond_badscale"):
        out = linprog(bbad.astype(np.float64), A_eq=Dbad.astype(np.float64),
                      b_eq=sbad.astype(np.float64), bounds=[(0, None)] * nlp, method="highs")
        res = linearprogram(bbad, Dbad, sbad, cfg, precondition=True, device=device)
        res_npc = linearprogram(bbad, Dbad, sbad, cfg, device=device)
        f_pre = float(bbad.astype(np.float64) @ f64(res.xopt))
        emit("lp_precond_badscale", 2e-3, abs(f_pre - out.fun) / (1.0 + abs(out.fun)), res,
             {"f_highs": float(out.fun), "steps_unpreconditioned": int(_host(res_npc.steps))})
    return rows


def device_line(device):
    """``(name, nvidia-smi's name and power limit)`` of a CUDA ``device``,
    or ``(str(device), None)``."""
    if device.type != "cuda":
        return str(device), None
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60)
    return torch.cuda.get_device_name(device), smi.stdout.strip().splitlines()[0] or None


def main(smoke=False, out_path="BENCH_MATRIX_TORCH.json", device="cuda", steps=None,
         only=None):
    """Both tables on ``device`` (the card unless asked for the CPU), written
    to ``out_path``; returns the document.  ``steps`` caps the timed
    steps, ``only`` (a set of row names) runs those rows alone."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("matrix: device is cuda but no CUDA device is visible; "
                           "pass --device cpu to run on the CPU")
    name, smi = device_line(device)
    t0 = time.perf_counter()
    timing = timing_matrix(smoke=smoke, device=device, steps=steps, only=only)
    acc = accuracy_matrix(smoke=smoke, device=device, only=only)
    doc = {"platform": "gpu" if device.type == "cuda" else device.type, "device": name,
           "nvidia_smi": smi, "torch": torch.__version__, "smoke": smoke, "steps": steps,
           "wall_s": time.perf_counter() - t0, "timing": timing, "f32_oracle_accuracy": acc}
    Path(out_path).write_text(json.dumps(doc, indent=1))
    print(f"# wrote {out_path} ({name}, {doc['wall_s']:.1f}s)")
    return doc


if __name__ == "__main__":
    import argparse

    ap = argparse.ArgumentParser(prog="admm_tpu_torch.benchmarks.matrix")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out", default="BENCH_MATRIX_TORCH.json")
    ap.add_argument("--steps", type=int, default=None)
    ap.add_argument("--rows", default=None)
    a = ap.parse_args()
    main(smoke=a.smoke, out_path=a.out, device=a.device, steps=a.steps,
         only=None if a.rows is None else set(a.rows.split(",")))
