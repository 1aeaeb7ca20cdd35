"""The whole fat-LASSO iteration, K steps in one launch (port of
``experiments/resident_iter_proto.py``).

The headline problem (``benchmarks/headline.make_problem``) with the
operands of the port's own f32 setup (``models/lasso.make_prox_ops``: E of
the f32 ``FatShiftSolver``, D^T s, lambda), and K = 64 steps of x-update,
soft threshold, dual update and the two residual norms in ONE launch of
the K3 kernel (``ops/gemv_pair.resident_lasso``; its plain PyTorch loop on
the CPU).  Prints the z, u and pn2 errors of the first launch against a
NumPy f64 run of the same sequence, then µs/iter and iter/s of 8 chained
launches (the state goes back through device memory between them).

The TPU prototype's ``f32 default`` row has no counterpart:
Precision.DEFAULT is a TPU matrix-unit setting, K3 is a CUDA-core GEMV
with f32 FMA, and the port keeps TF32 out of solver scope (``ROADMAP.md``,
numerics invariant).

Run: ``python -m admm_tpu_torch.experiments.resident_iter_proto [--smoke] [--device D]``.
"""

import argparse
import time

import numpy as np
import torch

from ..benchmarks.headline import make_problem
from ..config import ADMMConfig, matmul_precision
from ..engine import _sync
from ..models.lasso import make_prox_ops
from ..ops.gemv_pair import aligned_rows, resident_lasso

K = 64
CALLS = 8
RHO = 1.0


def setup(device="cuda", smoke=False):
    """The operands of K3 for the headline problem on ``device``: ``E``,
    ``Dt`` (row-major D^T), ``Dts``, ``rho`` and ``kappa = lam / rho`` as
    the engine computes it (f32)."""
    device = torch.device(device)
    D, s, lam = make_problem(smoke)
    with matmul_precision("highest"):
        _, _, _, data = make_prox_ops(torch.from_numpy(D).to(device),
                                      torch.from_numpy(s).to(device), lam,
                                      ADMMConfig(rho=RHO))
    fat = data["fat"]
    kappa = float(data["lam"] / torch.tensor(RHO, dtype=torch.float32, device=device))
    return {"E": aligned_rows(fat.E), "Dt": aligned_rows(fat.D.T), "Dts": data["Dts"],
            "rho": RHO, "kappa": kappa}


def numpy_reference(op, K=K):
    """``(z, u, hist)`` after K steps from z = u = 0 in NumPy f64 on the
    same (f32) operands."""
    E, Dt, Dts = (op[k].detach().cpu().double().numpy() for k in ("E", "Dt", "Dts"))
    rho, kappa = op["rho"], op["kappa"]
    z = np.zeros(Dts.size)
    u = np.zeros(Dts.size)
    hist = []
    for _ in range(K):
        b = Dts + rho * (z - u)
        x = b / rho - Dt @ (E @ b) / rho**2
        v = x + u
        z2 = np.sign(v) * np.maximum(np.abs(v) - kappa, 0.0)
        u = u + x - z2
        hist.append((np.sum((x - z2) ** 2), rho**2 * np.sum((z2 - z) ** 2)))
        z = z2
    return z, u, np.array(hist)


def run(device="cuda", smoke=False, K=K, calls=CALLS):
    """First launch from z = u = 0 checked against ``numpy_reference``,
    then ``calls`` chained launches timed on the host clock.  Returns a
    dict: the first launch's ``z``, ``u``, ``hist`` (tensors on the
    device), the max errors ``z_err`` and ``u_err`` (relative to the
    reference's max magnitude), ``pn2_err`` (relative, at step K),
    ``us_per_iter`` and ``iters_per_sec``."""
    device = torch.device(device)
    op = setup(device, smoke)
    args = (op["Dts"], op["E"], op["Dt"], op["rho"], op["kappa"], K)
    n = op["Dts"].numel()
    z = torch.zeros(n, dtype=torch.float32, device=device)
    u = torch.zeros_like(z)
    hist = resident_lasso(z, u, *args)
    _sync(device)
    z_np, u_np, hist_np = numpy_reference(op, K)

    def err(a, ref):
        return float(np.max(np.abs(a.cpu().numpy() - ref)) / (np.max(np.abs(ref)) + 1e-30))

    out = {"z": z, "u": u, "hist": hist, "z_err": err(z, z_np), "u_err": err(u, u_np),
           "pn2_err": abs(float(hist[K - 1, 0]) - hist_np[-1, 0]) / (hist_np[-1, 0] + 1e-30)}
    zc, uc = torch.zeros_like(z), torch.zeros_like(u)
    resident_lasso(zc, uc, *args)  # warm-up of the chain
    _sync(device)
    t0 = time.perf_counter()
    for _ in range(calls):
        resident_lasso(zc, uc, *args)
    _sync(device)
    dt = time.perf_counter() - t0
    out.update(us_per_iter=dt / (K * calls) * 1e6, iters_per_sec=K * calls / dt)
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--smoke", action="store_true", help="the headline's smoke size")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("resident_iter_proto: device is cuda but no CUDA device is visible")
    kind = torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"
    print(f"device: {kind}; K={K}, CALLS={CALLS}")
    r = run(device, args.smoke)
    print("z err vs numpy:", r["z_err"])
    print("u err:", r["u_err"])
    print(f"pn2 rel err @K-1: {r['pn2_err']}")
    print(f"{'resident full-iter f32 (one launch per K)':44s} {r['us_per_iter']:8.2f} us/iter"
          f"   {r['iters_per_sec']:10.0f} iter/s")
    return r


if __name__ == "__main__":
    main()
