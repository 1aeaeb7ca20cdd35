"""The consensus x-update's share of its roofline on rank 0: the least
time of the rank's local solves (the family's ``layer_cost('local_solve')``:
each shard's least inputs read once a step) for the steps each traced
request needed, over the device time of the kernels launched inside the
``step.xupdate`` spans (a kernel belongs to the span that holds the host
call carrying its correlation id), in %."""

from benchlib.roofline import share
from benchlib.spans import by_request, starting_in

UNIT = "%"
BETTER = "higher"
SOURCE = "device_trace"
LAYER = "parallel.consensus: local solves"
MOVES = "iter_per_s"
WORKLOADS = ["consensus_lasso_400000x8000.lambda_grid20"]


def read(run):
    pairs = by_request(run)
    spans = sorted((s for _, named in pairs for s in named.get("step.xupdate", [])),
                   key=lambda s: s.t0)
    if not spans:
        return None
    calls = {s.corr for s in starting_in([h for h in run.trace.host if h.corr >= 0], spans)}
    kernels = [k for k in run.trace.kernels if k.corr in calls]
    dev = sum(k.dur for k in kernels)
    least = run.least("local_solve", [r for r, _ in pairs])
    pct = None if least is None else share(least.seconds, dev)
    if pct is not None:
        run.notes.append(
            f"local_solve_roofline: least {1e6 * least.seconds:.3f} us ({least.bound}-bound: "
            f"{least.bytes / 1e9:.4f} GB, {least.flops / 1e9:.4f} GFLOP) over "
            f"{1e6 * dev:.3f} us of device in {len(kernels)} kernels of {len(spans)} sub-steps")
    return pct
