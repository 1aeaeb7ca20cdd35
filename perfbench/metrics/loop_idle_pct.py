"""The device's idle share of the engine's chunk loop, as the port marks
it: 1 - (the union of the device operations within the ``loop`` spans) /
(the ``loop`` spans' total), in %.  The loop starts after ``prepare``'s
device sync and ends in its last host read, which waits for the device,
so the device work the loop launches runs inside its span."""

from benchlib.spans import by_request, device_busy

UNIT = "%"
BETTER = "lower"
SOURCE = "program_span"
LAYER = "engine: host chunk loop"
MOVES = "iter_per_s"
WORKLOADS = ["lasso_boyd_1500x5000.solve", "tv1d_65536.solve", "lasso_boyd_1500x5000.path100"]


def read(run):
    pairs = by_request(run)
    loops = [s for _, named in pairs for s in named["loop"]]
    total = sum(s.dur for s in loops)
    if not total:
        return None
    engine = [e for e in run.trace.engine if e is not None]
    inside = sum(any(e[0] <= s.t0 and s.t1 <= e[1] for e in engine) for s in loops)
    run.notes.append(
        f"loop_idle_pct: {len(loops)} loop spans in {len(pairs)} requests, {inside} inside a "
        f"sync-bracketed engine interval; loop spans {1e6 * total:.3f} us against the engine "
        f"intervals' {1e6 * sum(e[1] - e[0] for e in engine):.3f} us")
    return 100.0 * (1.0 - device_busy(run, loops) / total)
