"""What the families share: the request record, the seeded request
order, the outcome of a call, and the port's options of a
configuration."""

from __future__ import annotations

import dataclasses
import random
from typing import Any


@dataclasses.dataclass
class Spec:
    """One request: the pool entry it solves and its regularisation (a
    float, or a device tensor of one per lane)."""

    index: int
    entry: int
    lam: Any


@dataclasses.dataclass
class Outcome:
    """What the system under test returned: x, z and u with a leading
    lane axis, each lane's steps (ints, or a device tensor read after
    the request's time is taken), the loop's own span, and whether the
    call reported a failure (divergence)."""

    x: Any
    z: Any
    u: Any
    steps: Any
    runtime: float
    failed: bool = False


def rounds(seed: int, pool: int):
    """Endless pool entries in rounds of ``pool`` requests, each round
    using every entry once in an order drawn from the seed.  So every seed
    gets the same work in another order, and a window that ends part way
    through a round is the only difference the seed makes."""
    rng = random.Random(seed)
    while True:
        yield from rng.sample(range(pool), pool)


def admm_config(config, **changes):
    """The port's ``ADMMConfig`` of a configuration: its stop and rho, its
    ``options``, and ``changes``."""
    from admm_tpu_torch import ADMMConfig

    stop = {k: config[k] for k in ("rho", "abstol", "reltol", "maxiters")}
    return ADMMConfig(**stop, **{**config["options"], **changes})
