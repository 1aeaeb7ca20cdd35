"""Probe: K chained GEMV pairs in one launch on the fat-LASSO shapes (port
of ``experiments/pallas_probe.py``).

Runs K = 64 steps of t = E b, x = D^T t in ONE launch of the K2 kernel
(``ops/gemv_pair.gemv_pair``; its plain PyTorch version on the CPU), 8
launches from the same b, with f32 and bf16 streams, and prints µs/iter
and iter/s per row.  The operands are the TPU probe's: E_n (n x m),
D_m (m x n) and b from ``default_rng(0)``, unpadded; the kernel reads
E = E_n^T and D^T = D_m^T as row-major copies.

The TPU probe's ``f32 default`` row has no counterpart: Precision.DEFAULT
is a TPU matrix-unit setting, K2 is a CUDA-core GEMV with f32 FMA, and the
port keeps TF32 out of solver scope (``ROADMAP.md``, numerics invariant).

Run: ``python -m admm_tpu_torch.experiments.gemv_pair_probe [--smoke] [--device D]``.
"""

import argparse
import time

import numpy as np
import torch

from ..engine import sync
from ..ops.gemv_pair import aligned_rows, gemv_pair

SHAPE = (1500, 5000)  # (m, n) of the fat-LASSO headline
SMOKE_SHAPE = (48, 160)
K = 64
CALLS = 8


def make_operands(m, n, device, dtype):
    """``(b, E, Dt)`` in ``dtype`` on ``device``: the TPU probe's draws
    (E_n, then D_m, then b from ``default_rng(0)``) at shape (m, n), E and
    Dt row-major with 16-byte aligned rows."""
    rng = np.random.default_rng(0)
    En = (rng.standard_normal((n, m)).astype(np.float32) / np.sqrt(n)).astype(np.float32)
    Dm = (rng.standard_normal((m, n)).astype(np.float32) / np.sqrt(m)).astype(np.float32)
    b = rng.standard_normal(n).astype(np.float32)

    def put(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(device=device, dtype=dtype)

    return put(b), aligned_rows(put(En.T)), aligned_rows(put(Dm.T))


def probe(device="cuda", smoke=False, K=K, calls=CALLS):
    """One row per stream dtype: ``{"name", "us_per_iter", "iters_per_sec",
    "finite"}``, timed on the host clock over ``calls`` launches of K steps
    after a warm-up launch (which also builds the kernel)."""
    device = torch.device(device)
    m, n = SMOKE_SHAPE if smoke else SHAPE
    rows = []
    for name, dtype in (("gemv pair f32", torch.float32), ("gemv pair bf16", torch.bfloat16)):
        b, E, Dt = make_operands(m, n, device, dtype)
        x = gemv_pair(b, E, Dt, K)
        sync(device)
        t0 = time.perf_counter()
        for _ in range(calls):
            x = gemv_pair(b, E, Dt, K)
        sync(device)
        dt = time.perf_counter() - t0
        iters = K * calls
        rows.append({"name": name, "us_per_iter": dt / iters * 1e6,
                     "iters_per_sec": iters / dt, "finite": bool(torch.isfinite(x).all())})
    return rows


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--smoke", action="store_true", help=f"{SMOKE_SHAPE} instead of {SHAPE}")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("gemv_pair_probe: device is cuda but no CUDA device is visible")
    kind = torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"
    m, n = SMOKE_SHAPE if args.smoke else SHAPE
    print(f"device: {kind}; m={m} n={n}; K={K} per launch, {CALLS} launches")
    rows = probe(device, args.smoke)
    for r in rows:
        print(f"{r['name']:40s} {r['us_per_iter']:8.2f} us/iter   "
              f"{r['iters_per_sec']:10.0f} iter/s")
    return rows


if __name__ == "__main__":
    main()
