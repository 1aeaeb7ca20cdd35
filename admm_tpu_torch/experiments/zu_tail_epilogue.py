"""K1b's time per call with each of its two cross-block reductions.

K1b (``ops/kernels.fused_zu_tail``, the tail mode of ``csrc/zu_tail.cu``)
adds its blocks' sums of squares either in one thread-block cluster
(distributed shared memory and two cluster barriers) or through global
scratch and a ticket taken by the last block (a fence and an atomic).
The launch plan (``kernels.zu_tail_plan``) takes the cluster for grids of
at most ``ZU_CLUSTER_BLOCKS`` blocks.  This probe runs both at sizes where
both apply, f32 and f64, in the order cluster, ticket, ticket, cluster;
checks that they give the same x, z, u and state bits and norms within
1e-5 (f32) / 1e-12 (f64) of each other; and prints the device time per
call (``benchmarks/timing.graph_ms``) beside the z/u mode's at the same n.
Needs a CUDA device.

Run: ``python -m admm_tpu_torch.experiments.zu_tail_epilogue``.
"""

import json
import math

import numpy as np
import torch

from ..benchmarks.timing import graph_ms
from ..ops import kernels
from ..ops.kernels import fused_soft_threshold_dual, fused_zu_tail, zu_tail_scratch

# Sizes whose grid fits one cluster (8 blocks: 8192 elements in f32, 4096
# in f64).
SIZES = ((1000, torch.float32), (5000, torch.float32), (8192, torch.float32),
         (4096, torch.float64))
CALLS = 2000


def operands(dev, dtype, n, seed=0):
    """(x_new, x, z, u, lam, rho, state, hist) and the keywords of a tail
    that never stops (domaxiters) on a history longer than the timing."""
    rng = np.random.default_rng(seed)
    vecs = [torch.from_numpy(rng.standard_normal(n)).to(dev, dtype) for _ in range(4)]
    lam = torch.tensor(0.3, dtype=dtype, device=dev)
    rho = torch.tensor(1.7, dtype=dtype, device=dev)
    state = torch.zeros(3, dtype=torch.int64, device=dev)
    hist = torch.full((4, 20 * CALLS), float("nan"), dtype=dtype, device=dev)
    kw = dict(perr_abs=math.sqrt(n) * 1e-4, derr_abs=math.sqrt(n) * 1e-4, reltol=1e-3,
              domaxiters=True, nodualerror=False, nanguard=True,
              scratch=zu_tail_scratch(n, dtype, dev))
    return [*vecs, lam, rho, state, hist], kw


def timed(dev, dtype, n, cluster_blocks):
    """(us per call, one call's outputs) with the plan's cluster limit set."""
    saved = kernels.ZU_CLUSTER_BLOCKS
    kernels.ZU_CLUSTER_BLOCKS = cluster_blocks
    try:
        ops, kw = operands(dev, dtype, n)
        once = [t.clone() for t in ops]
        fused_zu_tail(*once, **kw)
        us = graph_ms(lambda: fused_zu_tail(*ops, **kw), CALLS) * 1e3
    finally:
        kernels.ZU_CLUSTER_BLOCKS = saved
    return us, once


def main():
    if not torch.cuda.is_available():
        raise SystemExit("zu_tail_epilogue: no CUDA device is visible")
    dev = torch.device("cuda")
    print(f"device: {torch.cuda.get_device_name(dev)}; K1b us per call (graph replay, "
          f"{CALLS} calls), cluster / ticket in the order C T T C")
    rows = []
    for n, dtype in SIZES:
        blocks, cluster = kernels.zu_tail_plan(n, dtype.itemsize)
        if not cluster:
            raise SystemExit(f"zu_tail_epilogue: n={n} needs {blocks} blocks, over the cluster")
        c1, out_c = timed(dev, dtype, n, kernels.ZU_CLUSTER_BLOCKS)
        t1, out_t = timed(dev, dtype, n, 0)
        t2, _ = timed(dev, dtype, n, 0)
        c2, _ = timed(dev, dtype, n, kernels.ZU_CLUSTER_BLOCKS)
        if not all(torch.equal(a, b) for a, b in zip(out_c[1:4] + out_c[6:7],
                                                     out_t[1:4] + out_t[6:7])):
            raise SystemExit(f"zu_tail_epilogue: x, z, u or state differ at n={n} {dtype}")
        rtol = 1e-5 if dtype == torch.float32 else 1e-12
        if not torch.allclose(out_c[7][:, 0], out_t[7][:, 0], rtol=rtol, atol=0):
            raise SystemExit(f"zu_tail_epilogue: norms differ at n={n} {dtype}")
        vecs, _ = operands(dev, dtype, n)
        x, u = vecs[0], vecs[3]
        t = torch.tensor(0.3 / 1.7, dtype=dtype, device=dev)
        zu_us = graph_ms(lambda: fused_soft_threshold_dual(x, u, t), CALLS) * 1e3
        row = {"n": n, "dtype": str(dtype).split(".")[1], "blocks": blocks,
               "cluster_us": [c1, c2], "ticket_us": [t1, t2], "zu_mode_us": zu_us}
        rows.append(row)
        print(f"n={n} {row['dtype']} ({blocks} blocks): cluster {c1:.3f} / {c2:.3f}, "
              f"ticket {t1:.3f} / {t2:.3f}, z/u mode {zu_us:.3f}")
    print(json.dumps({"zu_tail_epilogue": rows}))


if __name__ == "__main__":
    main()
