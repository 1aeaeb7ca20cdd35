"""The whole ADMM step's share of the chip: (the steps each instance
needed x the whole step's least time, the family's ``layer_cost('step')``)
over the device's busy time in the engine loops (the union of the device
operations there), in %.  It bounds every kernel's share: a kernel taken
off the path leaves it standing."""

from benchlib.roofline import share
from benchlib.trace import union_seconds

UNIT = "%"
BETTER = "higher"
SOURCE = "device_trace"
LAYER = "device"
MOVES = "iter_per_s"
WORKLOADS = ["lasso_boyd_1500x5000.solve", "tv1d_65536.solve", "lasso_boyd_1500x5000.path100"]


def read(run):
    pairs = run.engine_pairs()
    if not pairs:
        return None
    least = run.least("step", [r for r, _ in pairs])
    if least is None:
        return None
    # Device operations that start in a loop end before its closing sync
    # returns, so the loops' union is the union of those operations.
    busy = union_seconds(run.trace.in_engine(run.trace.device))
    pct = share(least.seconds, busy)
    if pct is not None:
        run.notes.append(f"step_roofline: least {least.seconds * 1e6:.3f} us ({least.bound}-bound) "
                         f"over {busy * 1e6:.3f} us busy in the engine loops")
    return pct
