"""Per-request set-up of the entry: the mean, over the window's untraced
requests, of the harness's wall time around the call (to the returned
result, after a device synchronisation) less the port's own loop span,
``runtime``.  It holds the entry's set-up (placement, the x-update's
factorisation: LASSO's Gram and solve in ``models/lasso.make_prox_ops``,
TV's ``tv_system`` and the cyclic-reduction precompute), the result's
assembly and the syncs around the loop.  For a path it is per path."""

UNIT = "ms"
BETTER = "lower"
SOURCE = "program_span"
LAYER = "models: entry set-up"
MOVES = "solves_per_s"
WORKLOADS = ["lasso_boyd_1500x5000.solve", "tv1d_65536.solve", "lasso_boyd_1500x5000.path100"]


def read(run):
    reqs = [r for r in run.untraced if not r.failed]
    if not reqs:
        return None
    return 1e3 * sum(r.wall - r.runtime for r in reqs) / len(reqs)
