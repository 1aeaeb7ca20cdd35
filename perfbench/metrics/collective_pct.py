"""The share of rank 0's chunk loops in which an NCCL kernel ran on its
card: the union of the NCCL kernels' device intervals within the
``loop`` spans over those spans' total, in %.  A collective's kernel runs
from its launch until every rank has joined, so its time holds the wait
for the slowest rank as well as the transfer."""

import re

from benchlib.spans import by_request
from benchlib.trace import busy_intervals

UNIT = "%"
BETTER = "lower"
SOURCE = "device_trace"
LAYER = "parallel.mesh: collectives"
MOVES = "iter_per_s"
WORKLOADS = ["consensus_lasso_400000x8000.lambda_grid20"]
NCCL = re.compile(r"^nccl", re.IGNORECASE)


def read(run):
    pairs = by_request(run)
    loops = sorted((s for _, named in pairs for s in named["loop"]), key=lambda s: s.t0)
    total = sum(s.dur for s in loops)
    nccl = [k for k in run.trace.kernels if NCCL.search(k.name)] if loops else []
    if not total or not nccl:
        return None
    busy = sum(b - a for s in loops for a, b in busy_intervals(nccl, s.t0, s.t1))
    inside = sum(1 for k in nccl if any(s.t0 <= k.t0 < s.t1 for s in loops))
    calls = [c for _, named in pairs for c in named.get("collective", [])
             if any(s.t0 <= c.t0 < s.t1 for s in loops)]
    host = 1e6 * sum(c.dur for c in calls) / len(calls) if calls else 0.0
    run.notes.append(
        f"collective_pct: {inside} NCCL kernels in {len(loops)} loop spans of {len(pairs)} "
        f"requests, {1e6 * busy:.3f} us of {1e6 * total:.3f} us; {len(calls)} collective "
        f"spans there, {host:.3f} us of host each")
    return 100.0 * busy / total
