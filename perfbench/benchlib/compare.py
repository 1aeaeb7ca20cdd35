"""The comparison that decides ``correct``.

Every checked instance is held against the plain reference run over the
same inputs (``perfbench/reference/``), which re-derives every
factorisation itself.  Two numbers are compared, each the worst over the
checked instances of a run:

- ``iterate_gap``: the gap between the port's returned iterate
  w = (x, z, u) and the reference's iterate at the step count the port
  returned, ||w_port - w_ref|| / max(||w_ref||, median ||w_ref||) over
  the checked instances (the median guards an all but zero iterate);
- ``stop_lag``: |steps the port returned - the step at which the
  reference's own Boyd stop fires| (the cap where it never fires).

A run is correct when no request failed and each number is within its
limit (``perfbench/limits/<cell>.json``).
"""

from __future__ import annotations

import math

import torch


def numbers(port_outcomes, ref_results) -> dict:
    """``port_outcomes``: (x, z, u, steps) of each checked request, x/z/u
    ``(L, n)`` tensors and ``steps`` L ints; ``ref_results``: the
    reference's (x, z, u, own_steps) at those steps."""
    gaps, norms, lags = [], [], []
    for (xp, zp, up, kp), (xr, zr, ur, kr) in zip(port_outcomes, ref_results):
        wp = torch.cat([t.reshape(t.shape[0], -1).to("cpu", torch.float64)
                        for t in (xp, zp, up)], dim=1)
        wr = torch.cat([t.reshape(t.shape[0], -1).to("cpu", torch.float64)
                        for t in (xr, zr, ur)], dim=1)
        gaps.append(torch.linalg.vector_norm(wp - wr, dim=1))
        norms.append(torch.linalg.vector_norm(wr, dim=1))
        lags.extend(abs(int(a) - int(b)) for a, b in zip(kp, kr))
    gap = torch.cat(gaps)
    norm = torch.cat(norms)
    floor = torch.median(norm)
    rel = gap / torch.maximum(norm, floor)
    worst = float(rel.max()) if not torch.isnan(rel).any() else math.nan
    return {"iterate_gap": worst, "stop_lag": float(max(lags))}


def verdict(values: dict, limits: dict, failed: int) -> tuple:
    """``(correct, checks)``: checks maps each number to its value and
    limit, in the order of ``limits``."""
    checks = {}
    ok = failed == 0
    for name, spec in limits.items():
        if name.startswith("_"):
            continue
        v = values.get(name, math.nan)
        lim = float(spec["limit"])
        checks[name] = {"value": v, "limit": lim}
        ok = ok and (v == v) and v <= lim
    if not checks:
        ok = False
    return ok, checks
