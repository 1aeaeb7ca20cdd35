"""The share of the engine's chunks that ran as one replay of a captured
CUDA graph: the ``chunk`` spans of the traced requests that hold a
``replay`` span, over all their ``chunk`` spans, in %.  A chunk that ran
its sub-steps eagerly (no capture, or the first solve of its kind in the
process) holds none.  None where the program records no chunk spans."""

from benchlib.spans import by_request, starting_in

UNIT = "%"
BETTER = "higher"
SOURCE = "program_span"
LAYER = "engine: host chunk loop"
MOVES = "iter_per_s"
WORKLOADS = ["lasso_boyd_1500x5000.solve", "tv1d_65536.solve", "lasso_boyd_1500x5000.path100"]


def read(run):
    pairs = by_request(run)
    chunks = [s for _, named in pairs for s in named.get("chunk", [])]
    if not chunks:
        return None
    replays = [s for _, named in pairs for s in named.get("replay", [])]
    replayed = {id(c) for c in chunks if starting_in(replays, [c])}
    run.notes.append(f"replayed_chunk_pct: {len(replayed)} of {len(chunks)} chunks replayed in "
                     f"{len(pairs)} requests, {len(replays)} replays")
    return 100.0 * len(replayed) / len(chunks)
