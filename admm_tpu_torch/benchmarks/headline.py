"""Benchmark: ADMM iterations/sec on LASSO with dense D (1500 x 5000)
(port of ``admm_tpu/benchmarks/headline.py``).

Same problem generator, config and JSON keys as ``admm_tpu``'s headline,
run through the port with ``use_fused_kernel=True`` (the z/u pass and the
rest of the step's tail are one launch of the CUDA C++ kernel K1b on a
CUDA device).  ``vs_baseline`` compares against
the same single-process NumPy implementation of the iteration run on this
host.  Differences from ``admm_tpu``'s line:

- ``device`` names the device the solve ran on;
- ``fused_vs_plain_max_abs_diff`` is max |xopt_fused - xopt_plain| of the
  kernel path against the same solve with ``use_fused_kernel=False``;
- ``dispatch_floor_ms`` and ``marginal_iter_s`` (a probe of a remote
  device link) are not measured and print null.

``bf16_stream_iters_per_sec`` is measured as ``admm_tpu``'s: the same
config with ``stream_dtype=torch.bfloat16`` (the K2 kernel on a CUDA
device), best of 3 after a warm-up.

Run: ``python -m admm_tpu_torch.benchmarks.headline [--smoke] [--device D]``.
Prints ONE JSON line.  ``--profile`` prints a per-kernel device-time
breakdown of a shorter solve instead (``profile``); ``--variant`` picks an
engine variant of the headline or another family at
``admm_tpu/benchmarks/matrix.py``'s size (``FAMILY_VARIANTS``), or a cell of slices
7b and 8 through its entry point (``ENTRY_VARIANTS``).
"""

import argparse
import json
import time

import numpy as np


def _numpy_lasso_iters_per_sec(D, s, lam, rho, iters=50):
    """The reference's serial fat-lasso iteration in NumPy: Woodbury
    x-update via cached Cholesky (solvers/lasso.m:169-172,
    getProxOps.m:1198-1205) + soft-threshold z + dual update."""
    import scipy.linalg as sla

    m, n = D.shape
    Dts = D.T @ s
    G = D @ D.T / rho + np.eye(m)
    L = sla.cholesky(G, lower=True)
    x = np.zeros(n)
    z = np.zeros(n)
    u = np.zeros(n)
    t0 = time.perf_counter()
    for _ in range(iters):
        y = Dts + rho * (z - u)
        w = sla.solve_triangular(L.T, sla.solve_triangular(L, D @ y, lower=True))
        x = y / rho - (D.T @ w) / rho**2
        v = x + u
        z = np.sign(v) * np.maximum(np.abs(v) - lam / rho, 0.0)
        u = u + x - z
    dt = time.perf_counter() - t0
    return iters / dt


def numpy_lasso_pnorm(D, s, lam, rho, iters):
    """The same iteration in NumPy float64 (the update sequence of
    ``_numpy_lasso_iters_per_sec``), returning the primal residual
    ||x - z|| of every step: the reference trajectory for
    ``steps_to_rms_residual``."""
    import scipy.linalg as sla

    m, n = D.shape
    Dts = D.T @ s
    L = sla.cholesky(D @ D.T / rho + np.eye(m), lower=True)
    x = np.zeros(n)
    z = np.zeros(n)
    u = np.zeros(n)
    pnorm = np.empty(iters)
    for k in range(iters):
        y = Dts + rho * (z - u)
        w = sla.solve_triangular(L.T, sla.solve_triangular(L, D @ y, lower=True))
        x = y / rho - (D.T @ w) / rho**2
        v = x + u
        z = np.sign(v) * np.maximum(np.abs(v) - lam / rho, 0.0)
        u = u + x - z
        pnorm[k] = np.linalg.norm(x - z)
    return pnorm


def make_problem(smoke: bool = False):
    """The headline instance: dense column-normalised D, planted sparse
    signal, lambda = 0.1 ||D^T s||_inf, f32 (admm_tpu headline.py:60-66)."""
    m, n = (96, 320) if smoke else (1500, 5000)
    rng = np.random.default_rng(0)
    testx = rng.standard_normal(n) * (rng.random(n) < 0.1)
    D = rng.standard_normal((m, n)).astype(np.float32)
    D = D / np.sqrt(np.sum(D**2, axis=0, keepdims=True))
    s = (D @ testx + np.sqrt(0.001) * rng.standard_normal(m)).astype(np.float32)
    lam = float(0.1 * np.max(np.abs(D.T @ s)))
    return D, s, lam


def steps_to_rms_residual(pnorm, n, tol=1e-6):
    """First 1-based step whose primal residual is below tol per element
    (RMS): pnorm <= tol * sqrt(n).  None if never reached."""
    hit = np.nonzero(np.asarray(pnorm) <= tol * np.sqrt(n))[0]
    return int(hit[0]) + 1 if len(hit) else None


def main(smoke: bool = False, device: str = "cuda"):
    import torch

    from admm_tpu_torch import ADMMConfig
    from admm_tpu_torch.models.lasso import lasso

    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("headline: device is cuda but no CUDA device is visible")
    D, s, lam = make_problem(smoke)
    iters = 100 if smoke else 16384
    cfg = ADMMConfig(maxiters=iters, domaxiters=True, unroll=64)

    # Warm-up (kernel build), then best-of-3 timed passes, symmetric with
    # the best-of-3 NumPy baseline below.
    lasso(D, s, lam, cfg, use_fused_kernel=True, device=device)
    res = min((lasso(D, s, lam, cfg, use_fused_kernel=True, device=device)
               for _ in range(3)), key=lambda r: r.runtime)
    iters_per_sec = iters / res.runtime
    plain = lasso(D, s, lam, cfg, use_fused_kernel=False, device=device)
    fused_vs_plain = float(torch.max(torch.abs(res.xopt - plain.xopt)))

    # bf16-stream mode (FatShiftSolver stream_dtype), reported separately.
    lasso(D, s, lam, cfg, stream_dtype=torch.bfloat16, device=device)
    res_bf16 = min((lasso(D, s, lam, cfg, stream_dtype=torch.bfloat16, device=device)
                    for _ in range(3)), key=lambda r: r.runtime)
    bf16_iters_per_sec = iters / res_bf16.runtime

    baseline = max(
        _numpy_lasso_iters_per_sec(
            D.astype(np.float64), s.astype(np.float64), lam, cfg.rho,
            iters=20 if smoke else 50,
        )
        for _ in range(3)
    )

    # Secondary target: steps to an RMS primal residual of 1e-6.  Both
    # implementations run the same update sequence, so only seconds/step
    # differ.
    steps_1e6 = steps_to_rms_residual(res.pnorm, D.shape[1])
    t_1e6 = None if steps_1e6 is None else steps_1e6 / iters_per_sec
    t_1e6_np = None if steps_1e6 is None else steps_1e6 / baseline

    line = {
        "metric": "lasso_n5000_admm_iterations_per_sec_per_chip",
        "platform": "gpu" if device.type == "cuda" else device.type,
        "device": (torch.cuda.get_device_name(device) if device.type == "cuda"
                   else "cpu"),
        "value": round(iters_per_sec, 2),
        "unit": "iter/s",
        "vs_baseline": round(iters_per_sec / baseline, 3),
        "maxiters_per_dispatch": iters,
        "dispatch_floor_ms": None,
        "marginal_iter_s": None,
        "numpy_baseline_iters_per_sec": round(baseline, 2),
        "bf16_stream_iters_per_sec": round(bf16_iters_per_sec, 2),
        "steps_to_rms_residual_1e-6": steps_1e6,
        "time_to_rms_residual_1e-6_s": None if t_1e6 is None else round(t_1e6, 4),
        "baseline_time_to_rms_residual_1e-6_s": (
            None if t_1e6_np is None else round(t_1e6_np, 4)
        ),
        "fused_vs_plain_max_abs_diff": fused_vs_plain,
    }
    print(json.dumps(line))
    return line


# Engine variants ``profile`` can run on the headline problem: (config
# options, bf16 streams, lasso's fused hook).  'fused' is the headline's
# own loop (K1b, unroll 64); the others are chip_smoke.py's (n)-(p)
# (unroll 16), under domaxiters, so every step is timed.
VARIANTS = {
    "fused": (dict(unroll=64), False, True),
    "rbadaptive": (dict(unroll=16, rbadaptive=True), False, True),
    "anderson": (dict(unroll=16, anderson=5), False, True),
    "fast_weak_bf16": (dict(unroll=16, fast=True), True, False),
    "fast_strong_bf16": (dict(unroll=16, fast=True, fasttype="strong"), True, False),
}


# Families beside LASSO that ``profile`` runs in f32 at the sizes of
# admm_tpu/benchmarks/matrix.py's timed rows, on the generic step, with the
# unroll of their iteration body's class ('gemv' 16, 'heavy' 1) and the
# steps they are profiled over.
FAMILY_VARIANTS = {"basispursuit": (16, 2048), "lad": (16, 2048), "lp": (16, 2048),
                   "qp_bounded": (16, 2048), "covsel_eigh": (1, 200), "covsel_ns": (1, 200),
                   "sdp_diag_ns": (1, 200)}


def _family_setup(variant, cfg, smoke, device):
    """(prox_f, prox_g, obj, data, admm's wiring keywords) of a
    ``FAMILY_VARIANTS`` problem, float32 tensors on ``device``:
    - basispursuit: D 512 x 2048, a planted 10%-sparse x (matrix.py:387-395);
    - lad: D 4096 x 512, s N(0, 1) (matrix.py:416-424);
    - lp: n = 1024, D = |N(0, 1)|, s = D |x|, b in [0.5, 1.5), affine KKT
      (matrix.py:430-448), with D of n/2 rows: with matrix.py's square D
      (condition ~1e6) the float32 solve diverges at its first step
      (chip_smoke.py's LP phase);
    - qp_bounded: n = 2048, P = G G^T + n I, box [-1, 1] (matrix.py:465-474);
    - covsel_eigh, covsel_ns: D (4n, n) N(0, 1), lambda 0.1, n = 256 with
      the eigh x-prox and n = 512 with the Newton-Schulz one, profiled
      over the steps FAMILY_VARIANTS gives (200; matrix.py:476-493);
    - sdp_diag_ns: the max-cut relaxation of a 10%-dense graph, n = 512,
      Newton-Schulz z-prox with 16 steps (matrix.py:778-801)."""
    import torch

    rng = np.random.default_rng(0)
    f32 = lambda a: torch.as_tensor(a, dtype=torch.float32, device=device)  # noqa: E731
    if variant == "lad":
        from admm_tpu_torch.models.lad import make_prox_ops as make_lad

        m, n = (400, 50) if smoke else (4096, 512)
        D, s = f32(rng.standard_normal((m, n))), f32(rng.standard_normal(m))
        return (*make_lad(D, s, cfg), dict(A=D, B=-1.0, c=s, m=m, nA=n, nB=m))
    if variant == "lp":
        from admm_tpu_torch.models.linearprogram import make_prox_ops as make_lp

        n = 64 if smoke else 1024
        x = np.abs(rng.standard_normal(n))
        D = np.abs(rng.standard_normal((n // 2, n)))
        b = rng.random(n) + 0.5
        return (*make_lp(f32(b), f32(D), f32(D @ x), cfg), dict(m=n, nA=n, nB=n))
    if variant == "qp_bounded":
        from admm_tpu_torch.models.quadraticprogram import _obj, make_prox_ops_bounded

        n = 64 if smoke else 2048
        G = rng.standard_normal((n, n))
        P = f32(G @ G.T + n * np.eye(n))
        pf, pg, data = make_prox_ops_bounded(P, f32(rng.standard_normal(n)), f32(-np.ones(n)),
                                             f32(np.ones(n)), cfg)
        data.update(P=P, r=f32(0.0))
        return pf, pg, _obj, data, dict(m=n, nA=n, nB=n)
    if variant.startswith("covsel"):
        from admm_tpu_torch.models.covarianceselection import empirical_covariance
        from admm_tpu_torch.models.covarianceselection import make_prox_ops as make_cs

        n = 32 if smoke else (256 if variant == "covsel_eigh" else 512)
        S = empirical_covariance(f32(rng.standard_normal((4 * n, n))))
        method = "eigh" if variant == "covsel_eigh" else "ns"
        return (*make_cs(S, 0.1, cfg, prox_method=method), dict(shape_x=(n, n), shape_z=(n, n)))
    if variant == "sdp_diag_ns":
        from admm_tpu_torch.models.sdp import make_prox_ops as make_sdp

        n = 32 if smoke else 512
        W = np.triu(rng.random((n, n)) < 0.1, 1).astype(np.float64)
        W = W + W.T
        L = np.diag(W.sum(-1)) - W
        return (*make_sdp(f32(-0.25 * L), "diag", f32(np.ones(n)), cfg, prox_method="ns",
                          ns_iters=16), dict(shape_x=(n, n), shape_z=(n, n)))
    from admm_tpu_torch.models.basispursuit import make_prox_ops as make_bp

    m, n = (64, 256) if smoke else (512, 2048)
    D = rng.standard_normal((m, n)).astype(np.float32)
    x = rng.standard_normal(n) * (rng.random(n) < 0.1)
    return (*make_bp(f32(D), f32(D @ x), cfg), dict(m=n, nA=n, nB=n))


# Slice 7b and 8 cells ``profile`` runs through their entry points, f32 at
# admm_tpu/benchmarks/matrix.py's sizes, under domaxiters: name -> steps.
ENTRY_VARIANTS = {"rpca": 200, "logreg": 200, "lasso_batch": 300, "tv_batch": 300,
                  "lasso_path": 300}


def _entry_setup(variant, smoke, device):
    """``solve(cfg)`` of an ``ENTRY_VARIANTS`` cell, its operands float32
    tensors on ``device``:
    - rpca: rank 8 + 5% sparse, 256 x 256, exact SVT (matrix.py:528-539);
    - logreg: 4096 x 256, labels from a logistic model, lam 0.1, dense
      Newton x-prox (matrix.py:541-553);
    - lasso_batch, lasso_path: 128 lanes on the 1500 x 5000 column-normed D
      (matrix.py:656-681), signals X D^T + noise or 128 lambdas geomspaced
      from 0.001 to 0.5 lambda_max;
    - tv_batch: 128 random walks of n = 8192, lambda 1, solver 'cr' (the
      hybrid form, K4 once a sub-step; matrix.py:683-689)."""
    import torch

    from admm_tpu_torch import lasso_batch, lasso_path, logreg, rpca, tv_batch

    rng = np.random.default_rng(0)
    f32 = lambda a: torch.as_tensor(np.asarray(a), dtype=torch.float32, device=device)  # noqa: E731
    if variant == "rpca":
        n = 48 if smoke else 256
        M = f32(rng.standard_normal((n, 8)) @ rng.standard_normal((8, n))
                + (rng.random((n, n)) < 0.05) * 5 * rng.standard_normal((n, n)))
        return lambda cfg: rpca(M, config=cfg)
    if variant == "logreg":
        m, n = (256, 16) if smoke else (4096, 256)
        D = rng.standard_normal((m, n))
        ell = np.where(rng.random(m) < 1.0 / (1.0 + np.exp(-(D @ rng.standard_normal(n)))),
                       1.0, -1.0)
        D, ell = f32(D), f32(ell)
        return lambda cfg: logreg(D, ell, 0.1, cfg)
    if variant == "tv_batch":
        B, n = (8, 1000) if smoke else (128, 8192)
        S = f32(np.cumsum(rng.standard_normal((B, n)), axis=1))
        return lambda cfg: tv_batch(S, 1.0, cfg, solver="cr")
    B, (m, n) = (8, (48, 160)) if smoke else (128, (1500, 5000))
    D = rng.standard_normal((m, n))
    D /= np.sqrt(np.sum(D**2, axis=0, keepdims=True))
    if variant == "lasso_path":
        s = D @ (rng.standard_normal(n) * (rng.random(n) < 0.1))
        lmax = float(np.max(np.abs(D.T @ s)))
        lams = f32(np.geomspace(0.001 * lmax, 0.5 * lmax, B))
        D, s = f32(D), f32(s)
        return lambda cfg: lasso_path(D, s, lams, cfg)
    S = (rng.standard_normal((B, n)) * (rng.random((B, n)) < 0.1)) @ D.T
    S = S + 0.03 * rng.standard_normal((B, m))
    lam = float(0.1 * np.median(np.max(np.abs(S @ D), axis=1)))
    D, S = f32(D), f32(S)
    return lambda cfg: lasso_batch(D, S, lam, cfg)


def profile(smoke: bool = False, device: str = "cuda", iters: int = None, top: int = 12,
            variant: str = "fused"):
    """Where the time goes in the headline loop, in one of ``VARIANTS``,
    in a family of ``FAMILY_VARIANTS`` or in a cell of ``ENTRY_VARIANTS``
    (through its entry point; lanes' steps are sub-steps of all lanes).
    Sets up once, runs ``iters`` steps unprofiled (wall time per step),
    then the same solve under ``torch.profiler`` (device time of its
    kernels; setup is outside both).  Prints one JSON line: wall and
    device microseconds per step, the device's busy share (device time
    over unprofiled wall time), kernel launches per step, the device time
    per call of K1b (the z/u pass with the step's tail,
    ``zu_tail_kernel<float, true>``) where the variant runs it, and the
    ``top`` kernels by device time.  ``iters`` defaults to 2048, or to the
    family's own count in ``FAMILY_VARIANTS`` or ``ENTRY_VARIANTS``."""
    import torch
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as torch_profile

    from admm_tpu_torch import ADMMConfig, Hooks, admm
    from admm_tpu_torch.config import matmul_precision
    from admm_tpu_torch.models.lasso import _fused_zu, make_prox_ops

    if variant in ENTRY_VARIANTS:
        iters = iters or ENTRY_VARIANTS[variant]
        cfg = ADMMConfig(maxiters=iters, domaxiters=True)
        with matmul_precision("highest"):
            entry = _entry_setup(variant, smoke, device)

        def solve():
            return entry(cfg)
    elif variant in FAMILY_VARIANTS:
        unroll, steps = FAMILY_VARIANTS[variant]
        iters = iters or steps
        cfg = ADMMConfig(maxiters=iters, domaxiters=True, unroll=unroll)
        with matmul_precision("highest"):
            prox_f, prox_g, obj, data, wiring = _family_setup(variant, cfg, smoke, device)
        hooks = Hooks(obj=obj)
    else:
        iters = iters or 2048
        options, bf16, fused = VARIANTS[variant]
        D, s, lam = make_problem(smoke)
        n = D.shape[1]
        cfg = ADMMConfig(maxiters=iters, domaxiters=True, **options)
        with matmul_precision("highest"):
            prox_f, prox_g, obj, data = make_prox_ops(
                torch.as_tensor(D, device=device), torch.as_tensor(s, device=device), lam, cfg,
                stream_dtype=torch.bfloat16 if bf16 else None)
        wiring = dict(m=n, nA=n, nB=n)
        hooks = Hooks(obj=obj, fused_zu=_fused_zu if fused else None)

    if variant not in ENTRY_VARIANTS:
        def solve():
            return admm(prox_f, prox_g, cfg, data=data, hooks=hooks, dtype=torch.float32,
                        **wiring)

    solve()  # warm-up
    wall_us = min(solve().runtime for _ in range(2)) * 1e6 / iters
    with torch_profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        res = solve()
    steps = int(torch.as_tensor(res.steps).max())  # lanes: every lane runs iters
    kernels = [e for e in prof.key_averages()
               if str(e.device_type).endswith("CUDA")]

    def dev_us(e):
        return getattr(e, "self_device_time_total", None) or e.self_cuda_time_total

    device_us = sum(dev_us(e) for e in kernels) / steps
    zu = [e for e in kernels if "zu_tail_kernel" in e.key]
    kernels.sort(key=dev_us, reverse=True)
    line = {
        "profile": {
            "variant": variant,
            "steps": steps,
            "wall_us_per_step": wall_us,
            "profiled_wall_us_per_step": res.runtime * 1e6 / steps,
            "device_us_per_step": device_us,
            "busy_share": device_us / wall_us,
            "launches_per_step": sum(e.count for e in kernels) / steps,
            "zu_tail_kernel_us_per_call": (dev_us(zu[0]) / zu[0].count) if zu else None,
            "top": [[e.key[:80], dev_us(e) / steps, e.count / steps]
                    for e in kernels[:top]],
        }
    }
    print(json.dumps(line))
    return line


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--smoke", action="store_true", help="small problem, 100 steps")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--profile", action="store_true",
                    help="print a per-kernel device-time breakdown instead")
    ap.add_argument("--variant", default="fused",
                    choices=sorted(VARIANTS) + list(FAMILY_VARIANTS) + list(ENTRY_VARIANTS),
                    help="the engine variant --profile runs")
    args = ap.parse_args()
    if args.profile:
        profile(smoke=args.smoke, device=args.device, variant=args.variant)
    else:
        main(smoke=args.smoke, device=args.device)
