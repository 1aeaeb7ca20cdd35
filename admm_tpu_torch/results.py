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
      dnorm/perr/derr/objevals (admm.m:596-658).  ``diverged`` surfaces
      the nanguard abort as a flag.

    ``xopt``/``zopt``/``uopt`` and the ``hist`` tensors stay on the
    solve's device.  Trace tensors are fixed-size (maxiters) with NaN past
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
        return self.trace("objvals") if "objvals" in self.hist else None
