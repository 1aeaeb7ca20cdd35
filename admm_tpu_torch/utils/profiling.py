"""Profiling helpers (port of ``admm_tpu/utils/profiling.py``).

The reference's 'profiler' is tic/toc plus the full per-iteration history,
which ``ADMMResults`` keeps.  This module adds a device trace
(``torch.profiler`` with CUDA activity on the card, exported as a Chrome
trace viewable in Perfetto or chrome://tracing), the port's own spans in
that trace, and a steady-state solve-rate timer.

The spans (``span``) mark the port's layers on the profiler's clock, the
one CUPTI's device events use, as ``cpu_op`` events of the calling
thread.  The names, all under ``admm_tpu_torch.``:

  ``admm_tpu_torch.setup``         an entry's set-up, the x-update's
                                   factorisation (LASSO's Gram and solve;
                                   TV's tridiagonal system and its
                                   cyclic-reduction precompute; the
                                   consensus entries' per-shard inverses)
  ``admm_tpu_torch.prepare``       an entry's work before its runner
                                   (``engine.admm``: shapes, operators,
                                   initial iterates; ``paths.solve_lanes``:
                                   the runner; ``parallel.consensus_admm``)
                                   and the device sync that opens the loop
  ``admm_tpu_torch.loop``          the chunk loop (``engine._run_chunks``),
                                   first sub-step to last host read
  ``admm_tpu_torch.step``          one sub-step (once for all lanes)
  ``admm_tpu_torch.step.xupdate``  the sub-step's x-update (``prox_f``; a
                                   sharded runner's local solves)
  ``admm_tpu_torch.step.tail``     the rest of the sub-step: freeze mask,
                                   z-update, dual, norms, stop, history and
                                   freeze select, in every runner of
                                   ``engine.run_steps`` (on the fused LASSO,
                                   K1b's one launch)
  ``admm_tpu_torch.result``        the result's assembly and host reads
                                   (``engine.admm``, the path's,
                                   ``parallel.consensus_admm``)
  ``admm_tpu_torch.collective``    each collective a ``parallel.mesh.Mesh``
                                   issues over a process group

and, in ``engine._run_chunks`` and ``graphs.ChunkGraph``, ``chunk``,
``capture`` and ``replay``.

In a ``trace()`` file the device is idle in a gap between kernels, and
the innermost span over the gap says which layer of the host held it
there; a kernel belongs to the span whose interval holds its launch
(joined by the launch's correlation id), so per-phase launches and device
time of a sub-step follow from the ``step.*`` spans.  A span costs about
half a microsecond with no profiler running and records nothing then: the
profiler's own state is the only switch.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Callable

import torch

def span(name: str):
    """A context manager recording ``name`` as a span of the running
    ``torch.profiler`` (``trace()``), and nothing without one.  It never
    allocates, syncs or launches on the device."""
    return torch._C._profiler._RecordFunctionFast(name)


@contextlib.contextmanager
def trace(logdir: str):
    """Profile the block with ``torch.profiler``, the CPU always and CUDA
    when a card is visible, and write ``trace.json`` (Chrome trace format)
    into ``logdir``."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))


def _ready():
    if torch.cuda.is_available():
        torch.cuda.synchronize()


def iteration_rate(solve: Callable, *, warmup: int = 1, repeats: int = 3) -> float:
    """Steady-state solves/second of a zero-arg solve callable: runs
    ``warmup`` untimed calls (kernel builds, caches), then averages
    ``repeats`` calls, waiting for the card after each
    (``torch.cuda.synchronize`` in place of ``block_until_ready``)."""
    for _ in range(warmup):
        solve()
        _ready()
    t0 = time.perf_counter()
    for _ in range(repeats):
        solve()
        _ready()
    return repeats / (time.perf_counter() - t0)
