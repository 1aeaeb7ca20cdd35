"""The port's own spans in a trace, request by request.

``admm_tpu_torch.utils.profiling.span`` records the port's layers in the
profiler's trace as ``cpu_op`` events of the calling thread, on the clock
of CUPTI's device events; ``trace.summarise`` keeps them in
``TraceSummary.host`` with the request thread's other host operations.
Their names are ``admm_tpu_torch.`` and one of ``setup``, ``prepare``,
``loop``, ``step``, ``step.xupdate``, ``step.tail``, ``result`` (the
custom op ``admm_tpu_torch::cr_solve`` does not match).  A program that
records no spans gives no requests here, and every reader of them then
returns None.
"""

from __future__ import annotations

import bisect

from benchlib.trace import busy_intervals

PREFIX = "admm_tpu_torch."


def by_request(run) -> list:
    """``(request, {name: [Span, ...]})`` for each traced request that
    completed and whose spans hold a ``loop``, names without the prefix,
    each list in start order; [] where the trace and the requests
    disagree (as ``RunData.engine_pairs``)."""
    if run.trace is None or len(run.trace.requests) != len(run.traced):
        return []
    prog = [s for s in run.trace.host if s.name.startswith(PREFIX)]
    starts = [s.t0 for s in prog]
    out = []
    for r, req in zip(run.traced, run.trace.requests):
        if r.failed:
            continue
        named = {}
        for s in prog[bisect.bisect_left(starts, req.t0):bisect.bisect_left(starts, req.t1)]:
            named.setdefault(s.name[len(PREFIX):], []).append(s)
        if named.get("loop"):
            out.append((r, named))
    return out


def starting_in(items, intervals) -> list:
    """The ``items`` whose start lies in one of ``intervals`` (spans that
    do not overlap, in start order)."""
    starts = [iv.t0 for iv in intervals]
    out = []
    for s in items:
        k = bisect.bisect_right(starts, s.t0) - 1
        if k >= 0 and s.t0 < intervals[k].t1:
            out.append(s)
    return out


def device_busy(run, intervals) -> float:
    """Seconds of ``intervals`` in which some device operation ran."""
    if not intervals:
        return 0.0
    busy = busy_intervals(run.trace.device, min(iv.t0 for iv in intervals),
                          max(iv.t1 for iv in intervals))
    ends = [b for _, b in busy]
    total = 0.0
    for iv in intervals:
        for a, b in busy[bisect.bisect_right(ends, iv.t0):]:
            if a >= iv.t1:
                break
            total += min(b, iv.t1) - max(a, iv.t0)
    return total


def phase_launches(run, phase: str, metric: str):
    """Host launch calls starting inside the ``phase`` spans over the
    ``step`` spans of the traced requests; notes the phase's launches,
    host time and device time per sub-step (a device operation belongs to
    the phase whose span holds the host call it carries the correlation
    id of).  None without spans."""
    pairs = by_request(run)
    steps = sum(len(named.get("step", [])) for _, named in pairs)
    if not steps:
        return None
    spans = sorted((s for _, named in pairs for s in named.get(phase, [])), key=lambda s: s.t0)
    launches = starting_in(run.trace.launches, spans)
    calls = {s.corr for s in starting_in([h for h in run.trace.host if h.corr >= 0], spans)}
    device = sum(d.dur for d in run.trace.device if d.corr in calls)
    run.notes.append(
        f"{metric}: {phase} per sub-step {len(launches) / steps:.3f} launches, "
        f"{1e6 * sum(s.dur for s in spans) / steps:.3f} us of host, {1e6 * device / steps:.3f} us "
        f"of device; {steps} sub-steps of {len(pairs)} requests")
    return len(launches) / steps
