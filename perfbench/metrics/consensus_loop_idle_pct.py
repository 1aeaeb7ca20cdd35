"""The idle share of rank 0's card in the consensus chunk loop: 1 - (the
union of the device operations within the ``loop`` spans) / (the ``loop``
spans' total), in % (``loop_idle_pct``'s arithmetic on this cell).  The
loop starts after ``prepare``'s device sync and ends in its last host
read, which waits for the device."""

from benchlib.spans import by_request, device_busy

UNIT = "%"
BETTER = "lower"
SOURCE = "program_span"
LAYER = "engine: host chunk loop"
MOVES = "iter_per_s"
WORKLOADS = ["consensus_lasso_400000x8000.lambda_grid20"]


def read(run):
    loops = [s for _, named in by_request(run) for s in named["loop"]]
    total = sum(s.dur for s in loops)
    if not total:
        return None
    busy = device_busy(run, loops)
    run.notes.append(
        f"consensus_loop_idle_pct: {len(loops)} loop spans, {1e6 * total:.3f} us, the device "
        f"busy {1e6 * busy:.3f} us of it")
    return 100.0 * (1.0 - busy / total)
