"""Benchmark: ADMM iterations/sec on LASSO with dense D (1500 x 5000)
(port of ``admm_tpu/benchmarks/headline.py``).

Same problem generator, config and JSON keys as ``admm_tpu``'s headline,
run through the port with ``use_fused_kernel=True`` (the fused z/u pass
is a Triton kernel on a CUDA device).  ``vs_baseline`` compares against
the same single-process NumPy implementation of the iteration run on this
host.  Differences from ``admm_tpu``'s line:

- ``device`` names the device the solve ran on;
- ``fused_vs_plain_max_abs_diff`` is max |xopt_fused - xopt_plain| of the
  kernel path against the same solve with ``use_fused_kernel=False``;
- ``dispatch_floor_ms`` and ``marginal_iter_s`` (a probe of a remote
  device link) are not measured and print null;
- ``bf16_stream_iters_per_sec`` prints null until the bf16-stream mode is
  ported (ROADMAP K-ext-1).

Run: ``python -m admm_tpu_torch.benchmarks.headline [--smoke] [--device D]``.
Prints ONE JSON line.  ``--profile`` prints a per-kernel device-time
breakdown of a shorter solve instead (``profile``).
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
        "bf16_stream_iters_per_sec": None,
        "steps_to_rms_residual_1e-6": steps_1e6,
        "time_to_rms_residual_1e-6_s": None if t_1e6 is None else round(t_1e6, 4),
        "baseline_time_to_rms_residual_1e-6_s": (
            None if t_1e6_np is None else round(t_1e6_np, 4)
        ),
        "fused_vs_plain_max_abs_diff": fused_vs_plain,
    }
    print(json.dumps(line))
    return line


def profile(smoke: bool = False, device: str = "cuda", iters: int = 2048, top: int = 12):
    """Where the time goes in the fused headline loop.  Sets up once, runs
    ``iters`` steps unprofiled (wall time per step), then the same solve
    under ``torch.profiler`` (device time of its kernels; setup is outside
    both).  Prints one JSON line: wall and device microseconds per step,
    the device's busy share (device time over unprofiled wall time),
    kernel launches per step, the z/u kernel's device time per call, and
    the ``top`` kernels by device time."""
    import torch
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as torch_profile

    from admm_tpu_torch import ADMMConfig, Hooks, admm
    from admm_tpu_torch.config import matmul_precision
    from admm_tpu_torch.models.lasso import _fused_zu, make_prox_ops

    D, s, lam = make_problem(smoke)
    n = D.shape[1]
    cfg = ADMMConfig(maxiters=iters, domaxiters=True, unroll=64)
    with matmul_precision("highest"):
        prox_f, prox_g, obj, data = make_prox_ops(
            torch.as_tensor(D, device=device), torch.as_tensor(s, device=device), lam, cfg)

    def solve():
        return admm(prox_f, prox_g, cfg, m=n, nA=n, nB=n, data=data,
                    hooks=Hooks(obj=obj, fused_zu=_fused_zu), dtype=torch.float32)

    solve()  # warm-up
    wall_us = min(solve().runtime for _ in range(2)) * 1e6 / iters
    with torch_profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        res = solve()
    kernels = [e for e in prof.key_averages()
               if str(e.device_type).endswith("CUDA")]

    def dev_us(e):
        return getattr(e, "self_device_time_total", None) or e.self_cuda_time_total

    device_us = sum(dev_us(e) for e in kernels) / res.steps
    zu = [e for e in kernels if "fused_zu_kernel" in e.key]
    kernels.sort(key=dev_us, reverse=True)
    line = {
        "profile": {
            "steps": res.steps,
            "wall_us_per_step": wall_us,
            "profiled_wall_us_per_step": res.runtime * 1e6 / res.steps,
            "device_us_per_step": device_us,
            "busy_share": device_us / wall_us,
            "launches_per_step": sum(e.count for e in kernels) / res.steps,
            "fused_zu_kernel_us_per_call": (dev_us(zu[0]) / zu[0].count) if zu else None,
            "top": [[e.key[:80], dev_us(e) / res.steps, e.count / res.steps]
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
    args = ap.parse_args()
    if args.profile:
        profile(smoke=args.smoke, device=args.device)
    else:
        main(smoke=args.smoke, device=args.device)
