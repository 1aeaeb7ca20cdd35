"""The profiler trace of a steady part of the window, and its reduction.

``Capture`` runs ``torch.profiler`` (CPU and CUDA activities) over whole
requests, each inside a ``perfbench.request`` span that the harness
records around its own call into the port, and writes the Chrome trace
to a temporary file under ``TMPDIR`` that ``summarise`` reads and
deletes.

The port's engine synchronises the device right before and right after
its loop (``engine.admm`` and ``models/paths.solve_lanes``), so in every
request the first two ``cudaDeviceSynchronize`` calls bracket the
engine's host chunk loop.  Kernels launched between them run after the
first returns and end before the second returns, so a device operation
belongs to the loop when it starts between the end of the first and the
end of the second.
"""

from __future__ import annotations

import bisect
import dataclasses
import json
import os
import re
import tempfile

REQUEST_SPAN = "perfbench.request"
LAUNCH = re.compile(r"^(cuda|cu)(LaunchKernel|LaunchCooperativeKernel|GraphLaunch)")
SYNC = re.compile(r"^((cuda|cu)(Device|Stream|Event|Ctx)Synchronize|cudaMemcpy(_v\d+)?$"
                  r"|cuMemcpyDtoH(_v\d+)?$)")
DEVICE_SYNC = re.compile(r"^(cudaDeviceSynchronize|cuCtxSynchronize)")
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "cuda_runtime", "cuda_driver")


@dataclasses.dataclass
class Span:
    name: str
    t0: float   # seconds
    t1: float
    corr: int = -1

    @property
    def dur(self) -> float:
        return self.t1 - self.t0


@dataclasses.dataclass
class TraceSummary:
    """What the per-layer metrics read from one trace.

    ``requests``: the harness's request spans; ``engine``: for each, the
    host interval of the engine loop (None where two device syncs were not
    found); ``device``: every device operation; ``launches`` and ``syncs``:
    host calls; ``host``: host operations of the request thread."""

    requests: list
    engine: list
    device: list
    kernels: list
    launches: list
    syncs: list
    host: list

    @property
    def span(self) -> tuple:
        return self.requests[0].t0, self.requests[-1].t1

    def device_windows(self):
        """For each request with an engine loop, the device interval of
        its loop: from the end of the first sync to the end of the second."""
        return [(e[0], e[2]) for e in self.engine if e is not None]

    def in_engine(self, spans, device=True):
        """The spans that fall in an engine loop: by start time, against
        the device intervals (``device``) or the host intervals."""
        wins = self.device_windows() if device else \
            [(e[0], e[1]) for e in self.engine if e is not None]
        starts = [w[0] for w in wins]
        out = []
        for s in spans:
            k = bisect.bisect_right(starts, s.t0) - 1
            if k >= 0 and wins[k][0] <= s.t0 < wins[k][1]:
                out.append(s)
        return out

    def launch_count(self) -> int:
        """Host launch calls in the engine loops, plus the device
        operations there whose launch the trace did not record (a library
        linked with its own runtime may launch out of CUPTI's sight)."""
        host = self.in_engine(self.launches, device=False)
        seen = {s.corr for s in self.launches}
        dev = self.in_engine(self.kernels)
        return len(host) + sum(1 for k in dev if k.corr not in seen)

    def sync_count(self) -> int:
        return len(self.in_engine(self.syncs, device=False))


def union_seconds(spans, lo=None, hi=None) -> float:
    """The length of the union of ``spans``, clipped to [lo, hi]."""
    ivs = sorted((max(s.t0, lo) if lo is not None else s.t0,
                  min(s.t1, hi) if hi is not None else s.t1) for s in spans)
    total, cur0, cur1 = 0.0, None, None
    for a, b in ivs:
        if b <= a:
            continue
        if cur1 is None or a > cur1:
            if cur1 is not None:
                total += cur1 - cur0
            cur0, cur1 = a, b
        else:
            cur1 = max(cur1, b)
    if cur1 is not None:
        total += cur1 - cur0
    return total


def busy_intervals(spans, lo, hi):
    """The union of ``spans`` within [lo, hi] as sorted disjoint intervals."""
    out = []
    for a, b in sorted((max(s.t0, lo), min(s.t1, hi)) for s in spans):
        if b <= a:
            continue
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def summarise(events: list) -> TraceSummary:
    """Reduce the Chrome trace's events to a ``TraceSummary``."""
    reqs, dev, kern, launches, syncs, host_all = [], [], [], [], [], []
    req_tids = set()
    for e in events:
        if e.get("ph") != "X":
            continue
        cat, name = e.get("cat", ""), e.get("name", "")
        t0 = float(e["ts"]) * 1e-6
        s = Span(name, t0, t0 + float(e.get("dur", 0.0)) * 1e-6,
                 int((e.get("args") or {}).get("correlation", -1)))
        if cat == "user_annotation" and name == REQUEST_SPAN:
            reqs.append(s)
            req_tids.add(e.get("tid"))
        elif cat in DEVICE_CATS:
            dev.append(s)
            if cat == "kernel":
                kern.append(s)
        elif cat in HOST_CATS:
            host_all.append((e.get("tid"), s))
            if cat in ("cuda_runtime", "cuda_driver"):
                if LAUNCH.match(name):
                    launches.append(s)
                elif SYNC.match(name):
                    syncs.append(s)
    reqs.sort(key=lambda s: s.t0)
    for lst in (dev, kern, launches, syncs):
        lst.sort(key=lambda s: (s.t0, -s.dur))
    # A driver-level launch recorded inside a runtime-level one is the
    # same launch: keep the outer call only.
    kept = []
    for s in launches:
        if kept and s.t0 >= kept[-1].t0 and s.t1 <= kept[-1].t1:
            continue
        kept.append(s)
    launches = kept
    host = sorted((s for tid, s in host_all if tid in req_tids), key=lambda s: (s.t0, -s.dur))
    engine = []
    dsyncs = [s for s in syncs if DEVICE_SYNC.match(s.name)]
    starts = [s.t0 for s in dsyncs]
    for r in reqs:
        k = bisect.bisect_left(starts, r.t0)
        inside = [s for s in dsyncs[k:k + 2] if s.t1 <= r.t1]
        engine.append((inside[0].t1, inside[1].t0, inside[1].t1) if len(inside) == 2 else None)
    return TraceSummary(requests=reqs, engine=engine, device=dev, kernels=kern,
                        launches=launches, syncs=syncs, host=host)


def load(path: str) -> TraceSummary:
    with open(path) as f:
        data = json.load(f)
    return summarise(data["traceEvents"] if isinstance(data, dict) else data)


def top_device_ops(summary: TraceSummary, k: int = 10):
    """The device operations that took most time in the traced span,
    summed by name: ``[[name, seconds], ...]``."""
    lo, hi = summary.span
    tot = {}
    for s in summary.device:
        if lo <= s.t0 < hi:
            tot[s.name] = tot.get(s.name, 0.0) + s.dur
    return [[n[:120], v] for n, v in sorted(tot.items(), key=lambda kv: -kv[1])[:k]]


def idle_gaps(summary: TraceSummary, k: int = 10):
    """The device's idle time in the traced span, summed by what the host
    was doing at the middle of each gap (the innermost host operation of
    the request thread that covers it; ``host: python`` where none does):
    ``[[what, seconds], ...]``, the largest first."""
    lo, hi = summary.span
    busy = busy_intervals(summary.device, lo, hi)
    gaps, prev = [], lo
    for a, b in busy:
        if a > prev:
            gaps.append((prev, a))
        prev = max(prev, b)
    if hi > prev:
        gaps.append((prev, hi))
    host = summary.host
    tot, stack, j = {}, [], 0
    for a, b in gaps:
        mid = 0.5 * (a + b)
        # Sweep the request thread's properly nested host operations: the
        # stack holds those open at ``mid``, innermost on top.
        while j < len(host) and host[j].t0 <= mid:
            s = host[j]
            j += 1
            while stack and stack[-1].t1 < s.t0:
                stack.pop()
            stack.append(s)
        while stack and stack[-1].t1 < mid:
            stack.pop()
        label = stack[-1].name if stack else "host: python"
        tot[label] = tot.get(label, 0.0) + (b - a)
    return [[n[:120], v] for n, v in sorted(tot.items(), key=lambda kv: -kv[1])[:k]]


class Capture:
    """``torch.profiler`` over part of the window; ``summary`` after
    ``stop()``.  The Chrome trace goes to a temporary file under TMPDIR
    and is deleted once read."""

    def __init__(self, counters=None):
        self.prof = None
        self.summary = None
        self._counters = counters
        self._before = None
        self.counters = None

    def start(self):
        from torch.profiler import ProfilerActivity, profile

        import torch

        acts = [ProfilerActivity.CPU]
        if torch.cuda.is_available():
            acts.append(ProfilerActivity.CUDA)
        self.prof = profile(activities=acts)
        if self._counters is not None:
            self._before = self._counters()
        self.prof.start()

    def stop(self):
        import torch

        if torch.cuda.is_available():
            torch.cuda.synchronize()
        self.prof.stop()
        if self._counters is not None:
            after = self._counters()
            self.counters = {k: after[k] - self._before[k] for k in after}
        fd, path = tempfile.mkstemp(suffix=".json", prefix="perfbench_trace_")
        os.close(fd)
        try:
            self.prof.export_chrome_trace(path)
            self.summary = load(path)
        finally:
            os.unlink(path)
        self.prof = None
