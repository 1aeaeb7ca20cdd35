"""What a per-layer metric's reader gets: the run's requests, the traced
ones with the trace's summary, and the least-time arithmetic of the
cell's family over the steps each traced instance needed."""

from __future__ import annotations

import dataclasses
import re

from benchlib.roofline import Cost, share


@dataclasses.dataclass
class RunData:
    config: dict
    traffic: dict
    family: object
    requests: list          # every request of the window
    traced: list            # the traced ones, in order
    trace: object = None    # trace.TraceSummary of the traced ones
    notes: list = dataclasses.field(default_factory=list)

    @property
    def untraced(self):
        return [r for r in self.requests if not r.traced]

    def steps_covered(self, reqs=None) -> int:
        """The loop steps the requests needed: each request's largest
        instance step count (a lanes sub-step counts once)."""
        return sum(max(r.steps) for r in (self.traced if reqs is None else reqs))

    def least(self, layer: str, reqs=None):
        """The least-time work of ``layer`` over the steps each instance of
        the requests needed: at sub-step j, the instances whose own stop
        is at j or later.  None where the family has no such layer."""
        total = Cost()
        for r in (self.traced if reqs is None else reqs):
            ks = sorted(r.steps)
            prev = 0
            for i, k in enumerate(ks):
                if k > prev:
                    c = self.family.layer_cost(layer, self.config, len(ks) - i)
                    if c is None:
                        return None
                    total = total + c * (k - prev)
                    prev = k
        return total

    def engine_pairs(self):
        """(request, engine interval) of each traced request whose engine
        loop the trace shows, or [] where the trace and the requests
        disagree."""
        if self.trace is None or len(self.trace.requests) != len(self.traced):
            return []
        return [(r, e) for r, e in zip(self.traced, self.trace.engine) if e is not None]

    def engine_kernels(self, patterns):
        """The kernels in the engine loops whose name matches any of the
        regular expressions ``patterns``."""
        rx = re.compile("|".join(patterns))
        return [k for k in self.trace.in_engine(self.trace.kernels) if rx.search(k.name)]

    def roofline(self, name, patterns, layer, extra=()):
        """``name``'s share: the least time of ``layer`` (plus the work
        ``extra``, once a request) over the device time of the engine
        kernels matching ``patterns``; None where nothing ran."""
        pairs = self.engine_pairs()
        if not pairs:
            return None
        reqs = [r for r, _ in pairs]
        least = self.least(layer, reqs)
        if least is None:
            return None
        for once in extra:
            for r in reqs:
                least = least + self.family.layer_cost(once, self.config, r.instances)
        ks = self.engine_kernels(patterns)
        dev = sum(k.dur for k in ks)
        pct = share(least.seconds, dev)
        if pct is not None:
            self.notes.append(
                f"{name}: least {least.seconds * 1e6:.3f} us ({least.bound}-bound: "
                f"{least.bytes / 1e9:.4f} GB, {least.flops / 1e9:.4f} GFLOP) over "
                f"{dev * 1e6:.3f} us of device in {len(ks)} kernels, {sum(max(r.steps) for r in reqs)} "
                f"loop steps of {len(reqs)} requests")
        return pct
