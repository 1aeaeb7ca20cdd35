"""Group lasso: min 1/2 ||D x - s||^2 + lam sum_g w_g ||z_g||_2
s.t.  x - z = 0, where the coordinates of z are partitioned into groups
(port of ``admm_tpu/models/grouplasso.py``).

Beyond the reference (its shrinkage family stops at elementwise
soft-thresholding, getProxOps.m:933-938); standard ADMM formulation per
Boyd et al. §6.4.  The x-update is the shared least-squares prox
(``lasso.make_ls_xprox``); the z-update is group-wise block
soft-thresholding (``ops/prox.block_soft_threshold``), whose segment sums
are ``index_add_``.

``groups`` accepts any of
  - an int g: g equal consecutive groups (n must divide),
  - a sequence of group lengths shorter than n (consecutive groups,
    uneven ok),
  - an int array of EXACTLY length n: per-coordinate group ids in
    [0, num_groups) (need not be consecutive).
``weights`` defaults to 1 per group; pass e.g. sqrt(group sizes) for the
size-adjusted convention.

Not ported yet: ``grouplasso_batch`` (slice 8 of ROADMAP.md queue 1).
"""

from __future__ import annotations

import numpy as np
import torch

from ..config import ADMMConfig
from ..engine import Hooks, admm
from ..ops.prox import block_soft_threshold
from ..results import ADMMResults
from . import register
from ._common import bind_data, check_data_vector, merge_config, place_data, timed_solver
from .lasso import make_ls_xprox


def resolve_groups(groups, n):
    """Normalize a groups spec to ``(gid, num_groups)`` with ``gid`` an
    int64 numpy array of length n."""
    if isinstance(groups, (int, np.integer)):
        g = int(groups)
        if g <= 0 or n % g:
            raise ValueError(f"{g} equal groups do not tile n={n}")
        return np.repeat(np.arange(g), n // g), g
    arr = np.asarray(groups)
    if arr.ndim != 1:
        raise ValueError(f"groups must be 1-D, got shape {arr.shape}")
    if arr.shape[0] == n:
        # A length-n array is ALWAYS group ids (shorter arrays are group
        # lengths); ids must cover 0..max contiguously.
        ids = arr.astype(np.int64)
        num = int(ids.max()) + 1
        if ids.min() != 0 or len(np.unique(ids)) != num:
            if np.all(ids > 0) and ids.sum() == n:
                # The natural spelling of lengths happens to have length n
                # (e.g. np.ones(n) for n singleton groups): name the
                # ambiguity instead of the contiguity error.
                raise ValueError(
                    f"groups has length n={n}, so it is interpreted as "
                    "per-coordinate group IDS, but its entries look like "
                    "group LENGTHS (positive, summing to n). For singleton "
                    "groups pass np.arange(n) (ids) or the int n; for "
                    "lengths, a length-n lengths vector is ambiguous — "
                    "pass the equivalent id array instead."
                )
            raise ValueError("group ids must cover 0..max contiguously")
        return ids, num
    lengths = arr.astype(np.int64)
    if np.any(lengths <= 0) or lengths.sum() != n:
        raise ValueError(
            f"group lengths must be positive and sum to n={n}, got {lengths}"
        )
    return np.repeat(np.arange(len(lengths)), lengths), len(lengths)


def _prox_g(x, z, u, rho, d):
    return block_soft_threshold(x + u, d["lam"] * d["w"] / rho, d["gid"],
                                d["w"].shape[0])


def _obj(x, z, d):
    fit = 0.5 * torch.sum((d["D"] @ x - d["s"]) ** 2)
    norm2 = z.new_zeros(d["w"].shape[0]).index_add_(0, d["gid"], z * z)
    return fit + d["lam"] * torch.sum(d["w"] * torch.sqrt(norm2))


def make_prox_ops(D, s, lam, groups, weights=None,
                  config: ADMMConfig = ADMMConfig(), stream_dtype=None):
    """Build (prox_f, prox_g, obj, data) for the group lasso; ``D`` and
    ``s`` are tensors on the solve's device.  ``data`` carries lam, the
    per-group weights ``w`` and the membership ``gid`` (int64)."""
    prox_f, data = make_ls_xprox(D, s, config, stream_dtype)
    gid, num_groups = resolve_groups(groups, D.shape[1])
    dt, dev = D.dtype, D.device
    w = (torch.ones(num_groups, dtype=dt, device=dev) if weights is None
         else torch.as_tensor(np.asarray(weights), dtype=dt, device=dev))
    if tuple(w.shape) != (num_groups,):
        raise ValueError(f"weights must have shape ({num_groups},), got {tuple(w.shape)}")
    data["lam"] = torch.as_tensor(lam, dtype=dt, device=dev)
    data["w"] = w
    data["gid"] = torch.as_tensor(gid, dtype=torch.int64, device=dev)
    return prox_f, _prox_g, _obj, data


@register("grouplasso")
def _registry_entry(D, s, lam, groups, weights=None, config=ADMMConfig(), device=None, **_):
    D, s, _device = place_data(D, s, device)
    return bind_data(*make_prox_ops(D, s, lam, groups, weights, config))


@timed_solver
def grouplasso(D, s, lam, groups, weights=None,
               config: ADMMConfig = ADMMConfig(), *, stream_dtype=None,
               x0=None, z0=None, u0=None, device=None, **overrides) -> ADMMResults:
    """Solve the group lasso over the given coordinate groups.
    ``stream_dtype``, ``device`` and the warm start work as in ``lasso``.
    """
    check_data_vector(D, s)
    config = merge_config(config, overrides, body="gemv")
    D, s, device = place_data(D, s, device)
    n = D.shape[1]
    prox_f, prox_g, obj, data = make_prox_ops(D, s, lam, groups, weights,
                                              config, stream_dtype)
    return admm(
        prox_f, prox_g, config,
        A=1.0, B=-1.0, c=0.0, m=n, nA=n, nB=n,
        x0=x0, z0=z0, u0=u0,
        hooks=Hooks(obj=obj), dtype=D.dtype, data=data, device=device,
    )
