"""The collectives a sub-step of the consensus loop issues: rank 0's
``Mesh.stats`` all-reduce calls during the traced requests (each
request's count taken by the family around its call) over the sub-steps
their loops ran (the ``step`` spans; a chunk runs K sub-steps, some past
the stop).  The loop's step issues two (the means of x_i and u_i, then the
residual sum); the result's one all-gather follows the loop and is in the
note."""

from benchlib.spans import by_request

UNIT = "calls/substep"
BETTER = "lower"
SOURCE = "program_counter"
LAYER = "parallel.mesh: collectives"
MOVES = "iter_per_s"
WORKLOADS = ["consensus_lasso_400000x8000.lambda_grid20"]


def read(run):
    pairs = [(r, named) for r, named in by_request(run)
             if getattr(r.spec, "collectives", None) is not None]
    subs = sum(len(named.get("step", [])) for _, named in pairs)
    if not subs:
        return None
    calls = {}
    for r, _ in pairs:
        for op, k in r.spec.collectives.items():
            calls[op] = calls.get(op, 0) + k
    steps = sum(max(r.steps) for r, _ in pairs)
    run.notes.append(
        f"collectives_per_step: Mesh.stats calls {calls} over {len(pairs)} requests, "
        f"{subs} sub-steps run for {steps} steps needed")
    return calls.get("all_reduce", 0) / subs
