"""Shared solver-wrapper plumbing (port of ``admm_tpu/models/_common.py``:
``merge_config``, ``check_data_vector`` and ``timed_solver``)."""

from __future__ import annotations

import dataclasses
import time
from functools import wraps

import numpy as np

from ..config import ADMMConfig, matmul_precision, resolve_unroll


def merge_config(config: ADMMConfig, overrides: dict,
                 body: str = "default") -> ADMMConfig:
    """Apply keyword overrides to a config (the reference's pattern of
    solvers mutating the options struct before calling admm), then
    resolve ``unroll='auto'`` for the wrapper's iteration-body class."""
    if overrides:
        config = dataclasses.replace(config, **overrides)
    return resolve_unroll(config, body)


def check_data_vector(D, s, Dname="D", sname="s"):
    """Shape cross-check shared by the regression-style solvers (the
    reference's per-solver errorcheck subfunctions, e.g. lasso.m:132-141):
    D must be 2-D and s a vector of length rows(D).  Takes numpy arrays or
    tensors."""
    Dsh = tuple(np.shape(D))
    ssh = tuple(np.shape(s))
    if len(Dsh) != 2:
        raise ValueError(f"{Dname} must be 2-D, got shape {Dsh}")
    if len(ssh) != 1 or ssh[0] != Dsh[0]:
        raise ValueError(
            f"{sname} must be a vector of length {Dsh[0]} (rows of {Dname}), "
            f"got shape {ssh}"
        )


def timed_solver(fn):
    """Record whole-solver wall time as ``results.solverruntime``
    (reference: tic/toc around each solver, e.g. solvers/lasso.m:117,243).

    Also pins float32 matmuls to full precision (no TF32) for the solver's
    setup computations (Grams, factorizations): reduced-precision passes
    corrupt the solver algebra.  The pin is set for the call and the
    caller's settings are restored afterwards, so a global TF32 setting
    neither leaks in nor is changed.  The loop itself runs under
    ``config.matmul_precision`` (the engine sets it)."""

    @wraps(fn)
    def wrapper(*args, **kwargs):
        t0 = time.perf_counter()
        with matmul_precision("highest"):
            results = fn(*args, **kwargs)
        results.solverruntime = time.perf_counter() - t0
        return results

    return wrapper
