"""CUDA-graph capture of the engine's chunks.

The engine runs a solve in chunks of K sub-steps between host reads of its
stop flags (``engine._run_chunks``).  On a CUDA device, when every
callable the step runs is marked with ``capture_safe`` (it only launches
work on the current stream and never reads the device back on the host),
the engine captures one sub-step into a ``torch.cuda.CUDAGraph`` once per
solve and runs every chunk of the solve as K replays of it: the host then
pays one graph launch a sub-step in place of each of its launches.  The K
sub-steps of a chunk are the same on the host (the step index, the freeze
mask and the history slot live on the device), so one captured sub-step
stands for each of them; capturing one and not K keeps the capture's cost,
paid once a solve while the device waits, to one sub-step's host work.

  * The graph advances buffers the solve owns: the engine clones the
    step's state into them before the first chunk, and the captured
    sub-step ends by copying its new state back into them (``commit``).
    The host computes the chunk's flags from them after the last replay;
    a chunk of one sub-step has them computed in its graph instead, into a
    buffer of their own, so that it too is one launch.
  * Capture runs on one side stream per device, kept for the process,
    through ``capture_begin``/``capture_end`` in ``thread_local`` mode:
    unlike ``torch.cuda.graph``, nothing synchronises the device, so a
    solve's loop stays between the two device syncs that bracket it.  The
    replays run on the current stream.
  * Libraries set up their per-stream state at first use (cuBLAS's
    workspace), which a capture cannot do: the first chunk of the first
    solve of each kind (``ChunkGraph.kind``) in a process runs eagerly on
    the side stream instead, and the next chunk captures.
  * What the captured sub-step allocates lives in one private memory pool
    per device, which successive captures share: each device keeps its
    newest graph until the next capture, whose pool it names, so the pool
    never goes unheld between two solves.  A solve's own graph goes with
    the solve or, the newest, at the next capture.
  * The kernels' launch counters (``.launches`` of the wrappers in
    ``ops/``) count the kernels a replay runs, as an eager sub-step would.

Spans (``utils/profiling.span``): ``admm_tpu_torch.capture`` around the
capture and instantiation, ``admm_tpu_torch.replay`` around a chunk's
replays.
"""

from __future__ import annotations

import torch

from .utils.profiling import span


def capture_safe(obj):
    """Mark ``obj`` (a prox, a hook, or a linear operator's class) as safe
    to capture: what it does on a CUDA device is launch work on the
    current stream, with no host read of the device and nothing kept from
    one call to the next but caches it fills at its first call."""
    obj.capture_safe = True
    return obj


def is_capture_safe(obj) -> bool:
    return getattr(obj, "capture_safe", False) is True


def available(device) -> bool:
    """Whether a solve on ``device`` can run its chunks as graphs."""
    return device.type == "cuda"


def _counted():
    """The kernel wrappers whose ``.launches`` count their kernels."""
    from .ops import gemv_pair, kernels, tridiag

    return (kernels.fused_soft_threshold_dual, kernels.fused_zu_tail, tridiag.cr_solve,
            gemv_pair.gemv_pair, gemv_pair.resident_lasso)


# device -> [side stream, newest graph], kept for the process.
_SIDE: dict = {}
# (device, kind) whose first chunk ran eagerly on the side stream.
_WARM: set = set()


def _side(device):
    got = _SIDE.get(device)
    if got is None:
        got = _SIDE[device] = [torch.cuda.Stream(device), None]
    return got


class ChunkGraph:
    """One solve's sub-step as a CUDA graph: ``graph(step, flags, K)``
    runs one chunk of K sub-steps and returns the flags after it, an int64
    device pair.  ``step()`` runs one sub-step eagerly; ``commit()`` (None
    when the sub-step updates the solve's buffers in place) copies its
    result into the buffers the solve owns; ``flags()`` reads those
    buffers.  The first call captures them (or, for the first solve of its
    ``kind`` on the device, runs the chunk eagerly on the side stream);
    every chunk from then on replays the capture K times."""

    def __init__(self, device, kind, commit=None):
        self.device, self.kind, self.commit = device, kind, commit
        self.graph = self.counts = self.flags = None

    def _body(self, step, flags=None):
        step()
        if self.commit is not None:
            self.commit()
        if flags is not None:
            self.flags.copy_(flags())

    def __call__(self, step, flags, K):
        if self.graph is None:
            held = _side(self.device)
            side, cur = held[0], torch.cuda.current_stream(self.device)
            side.wait_stream(cur)
            if (self.device, self.kind) not in _WARM:
                with torch.cuda.stream(side):
                    for _ in range(K):
                        self._body(step)
                    out = flags()
                cur.wait_stream(side)
                _WARM.add((self.device, self.kind))
                return out
            if K == 1:
                self.flags = torch.empty(2, dtype=torch.int64, device=self.device)
            with span("admm_tpu_torch.capture"):
                self._capture(lambda: self._body(step, flags if K == 1 else None), held)
        with span("admm_tpu_torch.replay"):
            for _ in range(K):
                self.graph.replay()
        for fn, n in self.counts:
            fn.launches += K * n
        return self.flags if self.flags is not None else flags()

    def _capture(self, body, held):
        side, newest = held
        counted = _counted()
        before = [fn.launches for fn in counted]
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.stream(side):
            graph.capture_begin(pool=None if newest is None else newest.pool(),
                                capture_error_mode="thread_local")
            try:
                body()
            except BaseException:
                try:
                    graph.capture_end()
                except RuntimeError:
                    pass  # the capture is invalid; the body's error says why
                raise
            graph.capture_end()
        # A capture runs nothing: its launches count at each replay.
        self.counts = [(fn, fn.launches - n) for fn, n in zip(counted, before) if fn.launches != n]
        for fn, n in zip(counted, before):
            fn.launches = n
        self.graph = held[1] = graph
