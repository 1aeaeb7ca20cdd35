"""Unwrapped ADMM with transpose reduction (port of the serial solver of
``admm_tpu/models/unwrapped.py``).

Generic solver for problems of the form  min_x g(D x)  "unwrapped" as

    f(x) = 0,  g(z),   s.t.   D x - z = 0

so the x-update is a least-squares pull-back of z - u through D:
x = D^+ (z - u) (unwrappedadmm.m:76-78).  The distributed form
(unwrappedadmm.m:96-141) is ``parallel/transpose_reduction.py``.

Reference: solvers/unwrappedadmm.m.  Defaults preserved from
unwrappedadmm.m:81-92: A = D, B = -1, c = 0, random x0/z0/u0,
stopcond = 'both', nodualerror = 1.  D^+ is materialized once (pinv at
setup, as the reference does); every x-update is then one n-by-m GEMV.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch

from ..config import ADMMConfig
from ..device import resolve_device
from ..engine import Hooks, admm
from ..results import ADMMResults
from ._common import as_tensor, merge_config, timed_solver


def _prox_f(x, z, u, rho, d):
    return d["Dplus"] @ (z - u)


def random_start(seed, n, m, dtype, device):
    """The default start (unwrappedadmm.m:89-91): x0 (n,), z0 and
    u0 (m,), uniform on [0, 1), drawn in that order in f64 from a CPU
    ``torch.Generator`` seeded with ``seed``, then rounded to ``dtype`` and
    moved to ``device``, so that every device and dtype starts from the
    same point."""
    gen = torch.Generator().manual_seed(int(seed))
    return tuple(torch.rand(k, generator=gen, dtype=torch.float64).to(device=device, dtype=dtype)
                 for k in (n, m, m))


@timed_solver
def unwrappedadmm(
    prox_g: Callable,
    D,
    config: ADMMConfig = ADMMConfig(),
    *,
    obj: Optional[Callable] = None,
    seed: int = 0,
    data: Optional[dict] = None,
    x0=None,
    z0=None,
    u0=None,
    device=None,
    **overrides,
) -> ADMMResults:
    """Run unwrapped ADMM (reference solvers/unwrappedadmm.m:1).

    ``prox_g`` receives the raw x and is expected to apply D itself (as
    the reference's zminLinearSVM does, getProxOps.m:1084-1103).  When
    ``data`` is given, prox_g/obj follow the engine's data convention
    (module-level functions taking a trailing data dict; ``Dplus`` and
    ``D`` are added to it here).

    The random start is uniform on [0, 1) from ``random_start``: torch's
    generator, so it is not the draw ``admm_tpu`` takes from
    ``jax.random`` with the same seed, and runs of the two packages part
    from the first step unless x0, z0 and u0 are given.  Explicit x0/z0/u0
    warm starts override it (reference options.x0/z0/u0,
    admm.m:252-254).  The solve runs in D's dtype on ``device``, or on
    the device of D or of ``data``'s first tensor, or on the CUDA device
    (``device.resolve_device``).
    """
    # The reference forces stopcond='both' and nodualerror=1 (and clamps
    # maxiters to 1000, unwrappedadmm.m:90-92); the stopping semantics are
    # kept, the caller's iteration budget is respected.
    overrides.setdefault("stopcond", "both")
    overrides.setdefault("nodualerror", True)
    config = merge_config(config, overrides, body="gemv")

    device = resolve_device(device, D, data)
    D = as_tensor(D).to(device)
    m, n = D.shape
    Dplus = torch.linalg.pinv(D)

    start = random_start(seed, n, m, D.dtype, device)
    x0, z0, u0 = (given if given is not None else drawn
                  for given, drawn in zip((x0, z0, u0), start))

    if data is not None:
        data = dict(data)
        data["Dplus"] = Dplus
        data["D"] = D
        prox_f = _prox_f
    else:
        prox_f = lambda x, z, u, rho: Dplus @ (z - u)  # noqa: E731

    return admm(
        prox_f, prox_g, config,
        A=D, B=-1.0, c=0.0, m=m, nA=n, nB=m,
        x0=x0, z0=z0, u0=u0,
        hooks=Hooks(obj=obj), dtype=D.dtype, data=data, device=device,
    )
