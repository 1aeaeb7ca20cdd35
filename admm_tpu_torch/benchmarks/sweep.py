"""On-device solvertester sweep (port of ``admm_tpu/benchmarks/sweep.py``):
the reference's multi-scale, multi-trial harness (solvertester.m:151-240)
run in f32 on the card for every solver family, against the f32 bars of
``benchmarks/matrix.py`` (``_F32_ERRTOL``).

Writes ``BENCH_SWEEP_TORCH.json``: per-family failure matrix (scales x
trials), mean runtimes and steps per scale.  Seeded, so the sweep is
deterministic.

Run:  python -m admm_tpu_torch sweep [--smoke] [--device cpu] [--out F]
"""

from __future__ import annotations

import json
import time
from pathlib import Path

import numpy as np
import torch

from ..config import ADMMConfig
from ..testers.solvertester import _TESTERS, solvertester
from .matrix import _F32_ERRTOL, device_line

# Per-family sweep plan: (minscale, maxscale, extra tester kwargs),
# admm_tpu's.  Scales follow the reference's 2^s sizing with family caps
# (covsel's eigh truth construction is O(2^3s); the SVM floor is 256 per
# class regardless of scale, see testers/solvertester._shape).
_PLAN = {
    "model": (5, 7, {}),
    "lasso": (5, 7, {}),
    "basispursuit": (5, 7, {}),
    "totalvariation": (5, 7, {}),
    "lad": (5, 7, {}),
    "huberfit": (5, 7, {}),
    "linearprogram": (5, 7, {}),
    "quadraticprogram": (5, 7, {"form": "standard"}),
    "covarianceselection": (4, 6, {}),
    "linearsvm": (4, 5, {}),
}


def main(smoke: bool = False, trials: int = 2, seed: int = 7,
         out_path: str = "BENCH_SWEEP_TORCH.json", device: str = "cuda"):
    """The sweep in f32 on ``device`` (the card unless asked for the CPU);
    returns the document written to ``out_path``."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("sweep: device is cuda but no CUDA device is visible; "
                           "pass --device cpu to run on the CPU")
    name, smi = device_line(device)
    # f32-grade Boyd stops and the plateau detector (admm_tpu's settings;
    # some testers override abstol/reltol with their own, and the stall
    # window then stops them).
    cfg = ADMMConfig(abstol=1e-7, reltol=1e-6, stallwindow=100)

    t0 = time.perf_counter()
    families = []
    for solver in _TESTERS:
        lo, hi, kw = _PLAN[solver]
        if smoke:
            lo = hi = lo
        errtol = _F32_ERRTOL.get(solver, 1e-3)
        rep = solvertester(solver, lo, hi, trials=1 if smoke else trials, seed=seed,
                           errtol=errtol, config=cfg, device=device, dtype=torch.float32,
                           **kw)
        row = {
            "solver": solver,
            "scales": rep.scales,
            "errtol": errtol,
            "failures": rep.failed.astype(int).tolist(),
            "any_failed": bool(rep.any_failed),
            "mean_runtime_s": [float(v) for v in rep.avetimes],
            "mean_steps": [float(np.nanmean(rep.steps[i])) for i in range(len(rep.scales))],
            "stalled": rep.stalled.astype(int).tolist(),
        }
        if rep.avetimes01 is not None:
            row["mean_runtime_01_s"] = [float(v) for v in rep.avetimes01]
        print(json.dumps(row), flush=True)
        families.append(row)

    doc = {
        "platform": "gpu" if device.type == "cuda" else device.type,
        "device": name,
        "nvidia_smi": smi,
        "smoke": smoke,
        "trials": 1 if smoke else trials,
        "seed": seed,
        "wall_s": time.perf_counter() - t0,
        "all_green": not any(f["any_failed"] for f in families),
        "families": families,
    }
    Path(out_path).write_text(json.dumps(doc, indent=1))
    print(f"# wrote {out_path} ({name}, all_green={doc['all_green']}, {doc['wall_s']:.1f}s)")
    return doc


if __name__ == "__main__":
    import argparse

    ap = argparse.ArgumentParser(prog="admm_tpu_torch.benchmarks.sweep")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out", default="BENCH_SWEEP_TORCH.json")
    a = ap.parse_args()
    main(smoke=a.smoke, out_path=a.out, device=a.device)
