"""The measured window: one client in a closed loop, and the statistics
of every request it completed.

The client sends its next request when the last one returns, as a
caller waiting for its solution does.  The window opens when the first
request is sent and closes when the first request that returns after
``seconds`` returns, so every request sent is completed and counted, and
rates are taken over all the work and all the time of the window.
"""

from __future__ import annotations

import dataclasses
import math
import time
from typing import Callable, Optional


@dataclasses.dataclass
class Request:
    """One completed request: its host-clock span (``time.perf_counter``),
    the instances it returned, each instance's steps to its own stop,
    the sub-steps its loop ran, and the program's loop span."""

    index: int
    t0: float
    t1: float
    instances: int
    steps: list
    substeps: int
    runtime: float
    failed: bool
    traced: bool = False
    spec: object = None
    outcome: object = None

    @property
    def wall(self) -> float:
        return self.t1 - self.t0


@dataclasses.dataclass
class Window:
    requests: list
    t0: float
    t1: float

    @property
    def seconds(self) -> float:
        return self.t1 - self.t0


def run(issue: Callable[[int, bool], Request], seconds: float, *,
        trace_at: Optional[float] = None, trace_seconds: float = 0.0,
        start_trace: Callable = None, stop_trace: Callable = None) -> Window:
    """Issue requests ``issue(index, traced)`` back to back for ``seconds``.

    With ``trace_at`` (a share of ``seconds``), the requests that start
    from that point until ``trace_seconds`` have passed (one at least)
    run between ``start_trace()`` and ``stop_trace()``; a window that would
    close before that runs on until they have."""
    requests = []
    tracing = done_tracing = False
    trace_started = 0.0
    t_open = time.perf_counter()
    i = 0
    while True:
        now = time.perf_counter()
        if requests and now - t_open >= seconds and not tracing \
                and (trace_at is None or done_tracing):
            break
        if trace_at is not None and not tracing and not done_tracing \
                and now - t_open >= trace_at * seconds:
            start_trace()
            tracing, trace_started = True, time.perf_counter()
        req = issue(i, tracing)
        requests.append(req)
        i += 1
        if tracing and time.perf_counter() - trace_started >= trace_seconds:
            stop_trace()
            tracing, done_tracing = False, True
    return Window(requests=requests, t0=requests[0].t0, t1=requests[-1].t1)


def nearest_rank(values, q: float) -> float:
    """The q-quantile (0 < q <= 1) by the nearest-rank method: a value
    that one of the samples took."""
    ordered = sorted(values)
    k = max(1, math.ceil(q * len(ordered)))
    return ordered[k - 1]


def end_to_end(window: Window) -> dict:
    """The window's rates and tail over all its requests."""
    reqs = window.requests
    span = window.seconds
    return {
        "solves_per_s": sum(r.instances for r in reqs) / span,
        "iter_per_s": sum(sum(r.steps) for r in reqs) / span,
        "solve_ms_p95": 1e3 * nearest_rank([r.wall for r in reqs], 0.95),
        "solve_ms_p50": 1e3 * nearest_rank([r.wall for r in reqs], 0.50),
        "requests": len(reqs),
        "window_s": span,
    }
