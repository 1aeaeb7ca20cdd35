"""Device time of a call on a CUDA device, with the host's time per call
taken out: the call captured in a CUDA graph, the graph replayed between
two CUDA events.  Used by ``chip_smoke.py`` and the kernel experiments."""

from __future__ import annotations

import torch


def graph_ms(fn, reps, per_graph=10):
    """Mean device time in ms of one call of ``fn``: ``per_graph`` calls
    captured in a CUDA graph after a warm-up on a side stream, the graph
    replayed until ``reps`` calls have run between two CUDA events."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(per_graph):
            fn()
    graph.replay()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    replays = max(1, reps // per_graph)
    start.record()
    for _ in range(replays):
        graph.replay()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / (replays * per_graph)
