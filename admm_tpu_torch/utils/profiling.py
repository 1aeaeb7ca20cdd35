"""Profiling helpers (port of ``admm_tpu/utils/profiling.py``).

The reference's 'profiler' is tic/toc plus the full per-iteration history,
which ``ADMMResults`` keeps.  This module adds a device trace
(``torch.profiler`` with CUDA activity on the card, exported as a Chrome
trace viewable in Perfetto or chrome://tracing) and a steady-state
solve-rate timer.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Callable

import torch


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
