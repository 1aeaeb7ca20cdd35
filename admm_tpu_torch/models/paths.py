"""Regularization paths in one batched solve (port of
``admm_tpu/models/paths.py``).

Solve one problem family for a whole vector of regularization strengths
as B lanes of one program (``engine.make_admm_runner(lanes=True)``, the
port's counterpart of ``jax.vmap`` over the runner).  Every lane freezes
when it converges and reports its own step count; the batch runs until
the slowest lane is done.  The factorizations (Gram eigendecompositions,
projections, the cyclic-reduction elimination) are shared across the
lanes: only the scalar regularizer is stacked.
"""

from __future__ import annotations

import dataclasses
import functools
import time
from typing import Any

import torch

from ..config import ADMMConfig, matmul_precision
from ..device import resolve_device
from ..engine import Hooks, _sync, make_admm_runner
from ._common import as_tensor, merge_config


def highest_precision_setup(fn):
    """Run a batched solver's setup algebra (Grams, eigendecompositions,
    empirical covariances) with float32 matmuls at full precision, as
    ``timed_solver`` does for the serial solvers; the loop itself runs
    under ``config.matmul_precision``, which the runner sets
    (``admm_tpu``'s ``_highest_precision_setup``)."""

    @functools.wraps(fn)
    def wrapper(*args, **kwargs):
        with matmul_precision("highest"):
            return fn(*args, **kwargs)

    return wrapper


def check_mesh(mesh):
    """``mesh=`` shards the lanes over devices in ``admm_tpu``
    (``batch._shard_lanes``); it is not ported yet."""
    if mesh is not None:
        raise NotImplementedError(
            "mesh= (lanes sharded over a device mesh) is not ported yet "
            "(ROADMAP.md queue 1, slice 10)")


def solve_lanes(prox_f, prox_g, obj, config, mapped, data, x0, z0, u0, c, A, B):
    """Run the lanes to the end and return ``(raw dict, runtime)``: the
    runner's outputs with a leading lane axis and the loop's wall clock
    (set-up flushed before it starts)."""
    run = make_admm_runner(prox_f, prox_g, config, A, B, Hooks(obj=obj), has_data=True,
                           lanes=True, mapped=mapped)
    device = x0.device
    _sync(device)
    t0 = time.perf_counter()
    out = run(x0, z0, u0, c, data)
    _sync(device)
    return out, time.perf_counter() - t0


@dataclasses.dataclass
class PathResults:
    """Stacked per-lane results: leading axis = path position."""

    xopt: Any
    zopt: Any
    uopt: Any
    steps: Any       # (L,) iterations per lane
    lams: Any
    objopt: Any = None  # (L,) per-lane objective at the solution
    runtime: float = 0.0
    hist: dict = dataclasses.field(default_factory=dict)


def _path(prox_f, prox_g, obj, config, key, vals, data, x0, z0, u0, c, A, B):
    data = dict(data)
    data[key] = vals  # the stacked leaf
    out, runtime = solve_lanes(prox_f, prox_g, obj, config, {key}, data, x0, z0, u0, c, A, B)
    return PathResults(xopt=out["xopt"], zopt=out["zopt"], uopt=out["uopt"],
                       steps=out["steps"], lams=vals, objopt=out["objopt"],
                       runtime=runtime, hist=out["hist"])


@highest_precision_setup
def lasso_path(D, s, lams, config: ADMMConfig = ADMMConfig(), *, device=None,
               **overrides) -> PathResults:
    """Solve LASSO for every lambda in ``lams`` as lanes of one solve.

    Shares the one-time factorization across the path; only ``lam`` is
    stacked.  ``D``, ``s`` and ``device`` work as in ``lasso``."""
    from .lasso import make_prox_ops
    from ._common import place_data

    config = merge_config(config, overrides, body="batched")
    D, s, device = place_data(D, s, device)
    n = D.shape[1]
    lams = as_tensor(lams).to(device=device, dtype=D.dtype)
    prox_f, prox_g, obj, data = make_prox_ops(D, s, lams[0], config)
    zeros = D.new_zeros((lams.shape[0], n))
    return _path(prox_f, prox_g, obj, config, "lam", lams, data, zeros, zeros, zeros, zeros,
                 1.0, -1.0)


@highest_precision_setup
def covsel_path(D, lams, config: ADMMConfig = ADMMConfig(), *, prox_method: str = "ns",
                ns_iters: int = 20, device=None, **overrides) -> PathResults:
    """Graphical-lasso regularization path: covariance selection for every
    lambda in ``lams`` as lanes of one solve.  ``D`` holds samples in rows
    (the empirical covariance is shared; only lambda is stacked).  The
    x-prox defaults to the Newton-Schulz evaluation (GEMMs only, nothing
    read back); ``prox_method='eigh'`` batches the eigendecompositions."""
    from .covarianceselection import empirical_covariance, make_prox_ops

    config = merge_config(config, overrides, body="batched")
    device = resolve_device(device, D)
    S = empirical_covariance(as_tensor(D).to(device))
    n = S.shape[0]
    lams = as_tensor(lams).to(device=device, dtype=S.dtype)
    prox_f, prox_g, obj, data = make_prox_ops(S, lams[0], config, prox_method=prox_method,
                                              ns_iters=ns_iters)
    zeros = S.new_zeros((lams.shape[0], n, n))
    return _path(prox_f, prox_g, obj, config, "lam", lams, data, zeros, zeros, zeros, zeros,
                 1.0, -1.0)


@highest_precision_setup
def tv_path(s, lams, config: ADMMConfig = ADMMConfig(), *, solver: str = "auto",
            device=None, **overrides) -> PathResults:
    """1-D TV denoising for every lambda in ``lams`` as lanes of one solve
    (a denoising-strength sweep).  The x-prox's solve is lambda-free and
    shared; with a cyclic-reduction solver every lane's solve of a
    sub-step is one launch of K4 (``ops/tridiag.cr_solve``)."""
    from .totalvariation import make_prox_ops

    config = merge_config(config, overrides, body="batched")
    device = resolve_device(device, s)
    s = as_tensor(s).to(device)
    n = s.shape[0]
    lams = as_tensor(lams).to(device=device, dtype=s.dtype)
    prox_f, prox_g, obj, data, Dop = make_prox_ops(s, lams[0], config, solver)
    zeros = s.new_zeros((lams.shape[0], n))
    return _path(prox_f, prox_g, obj, config, "lam", lams, data, zeros, zeros, zeros, zeros,
                 Dop, -1.0)


@highest_precision_setup
def linearsvm_c_path(D, ell, Cs, config: ADMMConfig = ADMMConfig(), *, loss: str = "hinge",
                     seed: int = 0, device=None, **overrides) -> PathResults:
    """Train the linear SVM for every C in ``Cs`` as lanes of one solve
    (the reference's per-C re-solve loop, batched).  stopcond and
    nodualerror are forced to the unwrapped driver's values
    (unwrappedadmm.m:90-92), as the serial chain does, and every lane
    starts from ``unwrapped.random_start(seed)``, so each lane is the
    serial ``linearsvm(D, ell, C, seed=seed)``."""
    from ._common import place_data
    from .linearsvm import make_prox_ops
    from .unwrapped import _prox_f, random_start

    overrides["stopcond"] = "both"
    overrides["nodualerror"] = True
    config = merge_config(config, overrides, body="batched")
    D, ell, device = place_data(D, ell, device)
    m, n = D.shape
    Cs = as_tensor(Cs).to(device=device, dtype=D.dtype)
    _, prox_g, obj, data = make_prox_ops(D, ell, Cs[0], loss, config)
    data = dict(data)
    data["Dplus"] = torch.linalg.pinv(D)
    L = Cs.shape[0]
    x0, z0, u0 = (v.expand(L, -1).contiguous()
                  for v in random_start(seed, n, m, D.dtype, device))
    return _path(_prox_f, prox_g, obj, config, "C", Cs, data, x0, z0, u0, D.new_zeros((L, m)),
                 D, -1.0)
