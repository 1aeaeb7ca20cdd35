#!/usr/bin/env python3
"""Smoke run of the PyTorch port (admm_tpu_torch) on one CUDA GPU.

Run from the repository root:  python3 chip_smoke.py

It builds the port's GPU kernel from the sources in this checkout, checks
it against its plain PyTorch version, then drives the port's main path
(the headline fat LASSO, 1500 x 5000 in float32) through ``lasso`` with
the fused kernel and without it, and checks what comes out:

  1. device: nvidia-smi's name and power limit, torch's device name;
  2. kernel: the Triton z/u kernel against ``_fused_torch`` at several
     sizes in f32 and f64 (bar: bit-for-bit equal), and its time against
     the plain version's at n = 5000 (CUDA events);
  3. slice:
     (a) 16384 steps under domaxiters, unroll 64, fused kernel: steps ==
         16384, the kernel launched >= 16384 times in this run, finite
         xopt of shape (5000,);
     (b) the same without the kernel: max|xopt_a - xopt_b| <= 1e-6 ||xopt||_inf;
     (c) steps to an RMS primal residual of 1e-6 from (a)'s history,
         equal within one step to a NumPy float64 run of the same update
         sequence;
     (d) a converging run (maxiters 2000, unroll 16): steps < 2000 and
         equal with and without the kernel;
     (e) iter/s of (a) and (b), best of 3 each, taken in turns.

Every failed check raises, so the script exits non-zero.  It prints, on
lines before the last, the card's name and power limit and one JSON line
``{"kernels": [...]}``; the last line is
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
It exits non-zero, printing no result, when no CUDA device is visible.
The Triton build cache goes to build/triton/ in the checkout unless
TRITON_CACHE_DIR is set.
"""

import json
import os
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
KERNEL_SIZES = (64, 1000, 5000, 8192, 70000, 2**20)
HEADLINE_STEPS = 16384


def check(ok, what):
    if not ok:
        raise RuntimeError(f"chip_smoke: check failed: {what}")
    print(f"  ok: {what}")


def nvidia_smi_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def time_ms(fn, reps):
    """Mean device time of one call of fn over reps calls (CUDA events),
    after a warm-up."""
    import torch

    for _ in range(10):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def kernel_phase(dev):
    """K1 (Triton) against its plain version; returns (max_abs_err, ms, plain_ms)."""
    import torch

    from admm_tpu_torch.ops.kernels import _fused_torch, fused_soft_threshold_dual

    print("kernel: fused_soft_threshold_dual (Triton) vs _fused_torch")
    worst = 0.0
    for dtype in (torch.float32, torch.float64):
        for n in KERNEL_SIZES:
            rng = np.random.default_rng(n)
            x = torch.from_numpy(rng.standard_normal(n)).to(dev, dtype)
            u = torch.from_numpy(rng.standard_normal(n)).to(dev, dtype)
            t = torch.tensor(0.37, dtype=dtype, device=dev)
            z_k, u_k = fused_soft_threshold_dual(x, u, t)
            torch.cuda.synchronize()
            z_t, u_t = _fused_torch(x, u, t)
            dz = float(torch.max(torch.abs(z_k - z_t)))
            du = float(torch.max(torch.abs(u_k - u_t)))
            print(f"  {str(dtype):14s} n={n:8d}  max_abs_diff z={dz:.3e} u'={du:.3e}")
            check(dz == 0.0 and du == 0.0 and torch.isfinite(z_k).all(),
                  f"kernel == twin bit for bit ({dtype}, n={n})")
            worst = max(worst, dz, du)

    n = 5000  # the headline's vector length, f32
    rng = np.random.default_rng(1)
    x = torch.from_numpy(rng.standard_normal(n)).to(dev, torch.float32)
    u = torch.from_numpy(rng.standard_normal(n)).to(dev, torch.float32)
    t = torch.tensor(0.37, dtype=torch.float32, device=dev)
    ms = time_ms(lambda: fused_soft_threshold_dual(x, u, t), 2000)
    plain_ms = time_ms(lambda: _fused_torch(x, u, t), 2000)
    ms2 = time_ms(lambda: fused_soft_threshold_dual(x, u, t), 2000)
    plain_ms2 = time_ms(lambda: _fused_torch(x, u, t), 2000)
    print(f"  n=5000 f32 per call: kernel {ms:.5f} / {ms2:.5f} ms, "
          f"plain {plain_ms:.5f} / {plain_ms2:.5f} ms (CUDA events, 2000 calls each)")
    return worst, min(ms, ms2), min(plain_ms, plain_ms2)


def slice_phase(dev):
    """The main path; returns the kernel's launch count in run (a)."""
    import torch

    from admm_tpu_torch import ADMMConfig, lasso
    from admm_tpu_torch.benchmarks.headline import (
        make_problem, numpy_lasso_pnorm, steps_to_rms_residual)
    from admm_tpu_torch.ops.kernels import fused_soft_threshold_dual as k1

    D, s, lam = make_problem()
    m, n = D.shape
    cfg = ADMMConfig(maxiters=HEADLINE_STEPS, domaxiters=True, unroll=64)
    print(f"slice: lasso {m}x{n} f32, lam={lam:.6g}, {cfg.maxiters} steps, unroll {cfg.unroll}")

    # (a) the main path, counted.
    k1.launches = 0
    a = lasso(D, s, lam, cfg, use_fused_kernel=True, device=dev)
    torch.cuda.synchronize()
    launches = k1.launches
    print(f"  (a) fused: steps={a.steps} launches={launches} runtime={a.runtime:.4f}s "
          f"setup+solve={a.solverruntime:.4f}s")
    check(a.steps == HEADLINE_STEPS, f"(a) steps == {HEADLINE_STEPS}")
    check(launches >= HEADLINE_STEPS, f"(a) kernel launches {launches} >= {HEADLINE_STEPS}")
    check(a.xopt.device.type == "cuda" and tuple(a.xopt.shape) == (n,),
          "(a) xopt on the card with shape (5000,)")
    check(bool(torch.isfinite(a.xopt).all()) and not a.diverged, "(a) xopt finite")

    # (b) the same without the kernel.
    b = lasso(D, s, lam, cfg, use_fused_kernel=False, device=dev)
    diff = float(torch.max(torch.abs(a.xopt - b.xopt)))
    xinf = float(torch.max(torch.abs(a.xopt)))
    print(f"  (b) plain: steps={b.steps} runtime={b.runtime:.4f}s; "
          f"max|xopt_a - xopt_b| = {diff:.3e}, ||xopt||_inf = {xinf:.6g}, "
          f"ratio {diff / xinf:.3e}")
    check(b.steps == HEADLINE_STEPS, f"(b) steps == {HEADLINE_STEPS}")
    check(diff <= 1e-6 * xinf, "(b) max|xopt_fused - xopt_plain| <= 1e-6 ||xopt||_inf")

    # (c) steps to an RMS residual of 1e-6 against NumPy float64.
    steps_port = steps_to_rms_residual(a.pnorm, n)
    ref_pnorm = numpy_lasso_pnorm(D.astype(np.float64), s.astype(np.float64),
                                  lam, cfg.rho, iters=200)
    steps_np = steps_to_rms_residual(ref_pnorm, n)
    print(f"  (c) steps_to_rms_residual_1e-6: port f32 {steps_port}, "
          f"NumPy f64 {steps_np} (admm_tpu BENCH_r05.json records 60)")
    check(steps_port is not None and steps_np is not None
          and abs(steps_port - steps_np) <= 1, "(c) equal within one step")

    # (d) a converging run, stop rule on.
    cfg_d = ADMMConfig(maxiters=2000, unroll=16)
    d_fused = lasso(D, s, lam, cfg_d, use_fused_kernel=True, device=dev)
    d_plain = lasso(D, s, lam, cfg_d, use_fused_kernel=False, device=dev)
    print(f"  (d) converging: steps fused={d_fused.steps} plain={d_plain.steps}")
    check(d_fused.steps < 2000 and not d_fused.diverged, "(d) converges before 2000")
    check(d_fused.steps == d_plain.steps, "(d) equal steps fused and plain")
    check(bool(torch.isfinite(d_fused.xopt).all()), "(d) xopt finite")

    # (e) iter/s, best of 3 each, in turns (a is the first fused run).
    fused_t, plain_t = [a.runtime], [b.runtime]
    for fused, times in ((False, plain_t), (True, fused_t), (True, fused_t),
                         (False, plain_t)):
        r = lasso(D, s, lam, cfg, use_fused_kernel=fused, device=dev)
        times.append(r.runtime)
    print(f"  (e) runtimes s: fused {['%.4f' % t for t in fused_t]}, "
          f"plain {['%.4f' % t for t in plain_t]}")
    print(f"  (e) iter/s best of 3: fused {HEADLINE_STEPS / min(fused_t):.1f}, "
          f"plain {HEADLINE_STEPS / min(plain_t):.1f}")
    return launches


def main():
    import torch

    if not torch.cuda.is_available():
        sys.exit("chip_smoke: no CUDA device is visible; this script runs only on a GPU")
    os.environ.setdefault("TRITON_CACHE_DIR", str(ROOT / "build" / "triton"))
    sys.path.insert(0, str(ROOT))
    import admm_tpu_torch  # noqa: F401  (fails outside a checkout of the repo)

    smi = nvidia_smi_line()
    name = torch.cuda.get_device_name(0)
    print(f"device: {smi}")
    print(f"device: torch {torch.__version__}, CUDA {torch.version.cuda}, {name}, "
          f"count {torch.cuda.device_count()}")
    dev = torch.device("cuda", 0)

    t0 = time.perf_counter()
    max_err, ms, plain_ms = kernel_phase(dev)
    launches = slice_phase(dev)
    print(f"total {time.perf_counter() - t0:.1f}s")

    print(json.dumps({"kernels": [{
        "name": "fused_soft_threshold_dual",
        "route": "triton",
        "source": "admm_tpu_torch/ops/triton_fused_zu.py",
        "replaces": "admm_tpu/ops/kernels.py:48",
        "launches": launches,
        "max_abs_err": max_err,
        "ms": ms,
        "plain_ms": plain_ms,
    }]}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
