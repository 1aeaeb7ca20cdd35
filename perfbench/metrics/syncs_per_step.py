"""Host synchronisations of the engine's chunk loop per loop step: the
calls that wait for the device (``cuda*Synchronize``, a synchronous
``cudaMemcpy``; a device-to-host copy of a tensor read is one such
wait) between the two device syncs that bracket the loop, over the
steps the traced requests needed."""

UNIT = "syncs/step"
BETTER = "lower"
SOURCE = "device_trace"
LAYER = "engine: host chunk loop"
MOVES = "iter_per_s"
WORKLOADS = ["lasso_boyd_1500x5000.solve", "tv1d_65536.solve", "lasso_boyd_1500x5000.path100"]


def read(run):
    pairs = run.engine_pairs()
    if not pairs:
        return None
    steps = run.steps_covered([r for r, _ in pairs])
    return run.trace.sync_count() / steps if steps else None
