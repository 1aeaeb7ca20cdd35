"""The least time a layer can take on one H100, from its shapes.

Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, at its 700 W
limit): 3.35 TB/s of HBM3 and 67 TFLOP/s in float32 outside the tensor
cores.  A layer's bytes count each input byte read once and each output
byte written once, whatever a kernel reads again; its operations are the
float32 operations the algorithm needs.  The least time is the larger of
bytes over bandwidth and operations over the peak rate, whichever kernel
implements the layer.  Work that depends on the data (a solve that stops
early, lanes that freeze) is counted for the steps each instance needs.
"""

from __future__ import annotations

import dataclasses

HBM_BYTES_PER_S = 3.35e12
F32_FLOP_PER_S = 67e12
PEAK_POWER_W = 700.0
L2_BYTES = 50 * 2**20


@dataclasses.dataclass(frozen=True)
class Cost:
    """Bytes moved and float operations of some work."""

    bytes: float = 0.0
    flops: float = 0.0

    def __add__(self, other: "Cost") -> "Cost":
        return Cost(self.bytes + other.bytes, self.flops + other.flops)

    def __mul__(self, k: float) -> "Cost":
        return Cost(self.bytes * k, self.flops * k)

    __rmul__ = __mul__

    @property
    def byte_seconds(self) -> float:
        return self.bytes / HBM_BYTES_PER_S

    @property
    def flop_seconds(self) -> float:
        return self.flops / F32_FLOP_PER_S

    @property
    def seconds(self) -> float:
        """The least time of this work taken alone."""
        return max(self.byte_seconds, self.flop_seconds)

    @property
    def bound(self) -> str:
        return "bytes" if self.byte_seconds >= self.flop_seconds else "operations"


def fat_lasso_xupdate(m: int, n: int, lanes: int = 1, itemsize: int = 4) -> Cost:
    """The fat-LASSO x-update x = (D^T D + rho I)^{-1} q over ``lanes``
    right-hand sides, at its least inputs: by the matrix-inversion lemma
    x = (q - D^T (rho I + D D^T)^{-1} D q) / rho needs D (m x n) and one
    triangular or symmetric m x m factor, m (m + 1) / 2 words, each read
    once; q read and x written per lane.  Operations: the two products with
    D, 2 m n multiply-adds each a lane; the m x m apply is left out, since
    a variant that folds it into a second m x n matrix does without it.
    It counts neither that second matrix (the port's E) nor D read twice."""
    return Cost(bytes=(m * n + m * (m + 1) // 2 + 2 * n * lanes) * itemsize,
                flops=4.0 * m * n * lanes)


def gemv(m: int, n: int, lanes: int = 1, itemsize: int = 4) -> Cost:
    """One m x n matrix times ``lanes`` vectors."""
    return Cost(bytes=(m * n + (m + n) * lanes) * itemsize, flops=2.0 * m * n * lanes)


def soft_threshold_tail(n: int, lanes: int = 1, itemsize: int = 4) -> Cost:
    """LASSO's z/u pass and step tail (K1b's work): read x, z and u,
    write z and u; soft threshold, dual update and the four norms of the
    Boyd stop (~16 operations an element)."""
    return Cost(bytes=5 * n * lanes * itemsize, flops=16.0 * n * lanes)


def tridiagonal_solve(n: int, lanes: int = 1, itemsize: int = 4) -> Cost:
    """A solve of one tridiagonal system of order n for ``lanes``
    right-hand sides: the three diagonals read once, each right-hand side
    read and each solution written; ~8 operations a row and lane."""
    return Cost(bytes=(3 * n + 2 * n * lanes) * itemsize, flops=8.0 * n * lanes)


def lasso_step(m: int, n: int, lanes: int = 1, itemsize: int = 4) -> Cost:
    """One whole fat-LASSO ADMM step: the x-update's least inputs (D and an
    m x m factor, as ``fat_lasso_xupdate``) and D^T s read once, z and u
    read and x, z and u written per lane; the two products with D plus ~30
    element-wise operations an element."""
    return Cost(bytes=(m * n + m * (m + 1) // 2 + n + 5 * n * lanes) * itemsize,
                flops=(4.0 * m * n + 30.0 * n) * lanes)


def tv_step(n: int, lanes: int = 1, itemsize: int = 4) -> Cost:
    """One whole 1-D TV ADMM step: s and the three diagonals of
    I + rho D^T D read once, z and u read and x, z and u written per lane;
    the tridiagonal solve plus ~40 element-wise operations an element
    (D and D^T applications, soft threshold, dual update, norms)."""
    return Cost(bytes=(4 * n + 5 * n * lanes) * itemsize, flops=48.0 * n * lanes)


def share(least_seconds: float, device_seconds: float):
    """Least time over device time in %, or None where nothing ran."""
    if device_seconds <= 0.0 or least_seconds <= 0.0:
        return None
    return 100.0 * least_seconds / device_seconds
