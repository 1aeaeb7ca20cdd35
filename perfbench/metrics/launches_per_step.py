"""Host launch calls of the engine's chunk loop per loop step: the
launch API calls the trace records between the two device syncs that
bracket the loop (``cudaLaunchKernel``, ``cuLaunchKernel``, the
cooperative and extended forms, ``cudaGraphLaunch``), plus any kernel
there whose launch the trace missed, over the steps the traced requests
needed (a lanes sub-step counts once; the sub-steps a chunk runs past an
instance's stop are not steps it needed)."""

UNIT = "launches/step"
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
    return run.trace.launch_count() / steps if steps else None
