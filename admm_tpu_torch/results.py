"""Results container (port of ``admm_tpu/results.py``; reference:
admm.m:746-767 plus per-iteration records admm.m:596-658)."""

from __future__ import annotations

import dataclasses
from typing import Any, Optional

import numpy as np


@dataclasses.dataclass
class ADMMResults:
    """Solve results.

    Fields named after the reference's results struct:
      xopt/zopt/uopt (admm.m:747-749), steps (admm.m:746), objopt
      (admm.m:752-753), runtime (admm.m:756), per-iteration traces pnorm/
      dnorm/perr/derr/objevals/Hnormsq/dvals/avals/restarted and optional
      xvals/zvals/uvals/vvals/uhatvals/wvals (admm.m:596-658).
      ``diverged`` surfaces the reference's convergence-monitor abort
      (admm.m:686-703) and the nanguard abort as a flag; ``stalled`` the
      plateau stop (``ADMMConfig.stallwindow``, no reference analog).

    ``xopt``/``zopt``/``uopt`` and the ``hist`` tensors stay on the
    solve's device.  Trace tensors are fixed-size (maxiters, leading axis)
    with NaN (zeros for ``restarted`` and the iterate records) past
    ``steps``; ``trace()`` copies the valid prefix to host numpy.
    """

    xopt: Any
    zopt: Any
    uopt: Any
    steps: int
    objopt: Optional[float]
    diverged: bool
    rho_final: float
    hist: dict
    config: Any
    x0: Any = None
    z0: Any = None
    u0: Any = None
    runtime: float = 0.0
    solverruntime: float = 0.0
    extra: dict = dataclasses.field(default_factory=dict)
    stalled: bool = False

    @classmethod
    def from_raw(cls, raw: dict, config, x0=None, z0=None, u0=None) -> "ADMMResults":
        objopt = raw.get("objopt")
        return cls(
            xopt=raw["xopt"],
            zopt=raw["zopt"],
            uopt=raw["uopt"],
            steps=int(raw["steps"]),
            objopt=None if objopt is None else float(objopt),
            diverged=bool(raw["diverged"]),
            stalled=bool(raw.get("stalled", False)),
            rho_final=float(raw["rho_final"]),
            hist=dict(raw["hist"]),
            config=config,
            x0=x0,
            z0=z0,
            u0=u0,
        )

    def trace(self, name: str) -> np.ndarray:
        """Valid (length-``steps``) prefix of a per-iteration trace, as
        host numpy."""
        return self.hist[name][: self.steps].cpu().numpy()

    def _optional(self, name):
        return self.trace(name) if name in self.hist else None

    @property
    def pnorm(self):
        return self.trace("pnorm")

    @property
    def dnorm(self):
        return self.trace("dnorm")

    @property
    def perr(self):
        return self.trace("perr")

    @property
    def derr(self):
        return self.trace("derr")

    @property
    def objevals(self):
        return self._optional("objvals")

    @property
    def Hnormsq(self):
        return self._optional("Hnormsq")

    @property
    def dvals(self):
        return self._optional("dvals")

    @property
    def restarted(self):
        return self._optional("restarted")

    @property
    def wvals(self):
        """Stacked w = [x; z; rho*u] per iteration (admm.m:680-682);
        recorded under ``record_iterates``."""
        return self._optional("wvals")
