"""K4's time per solve against the hybrid form's tile length.

Runs ``ops/tridiag.cr_solve`` on the 1-D TV system (hybrid cutoff 1023,
f32) at (lanes, n) = (1, 65536), (128, 8192) and (8, 65536) with tiles of
512 to 8192 rows (``tridiag.TILE_ROWS``, the plan's floor, set for each
run), checks each solve against the plain version bit for bit, and prints
the device time per solve (``benchmarks/timing.graph_ms``).  The rule in
``tridiag.tile_plan`` (about ``TARGET_TILES`` tiles a launch) comes from
this sweep.  Needs a CUDA device.

Run: ``python -m admm_tpu_torch.experiments.cr_tile_sweep``.
"""

import torch

from ..benchmarks.timing import graph_ms
from ..models.totalvariation import tv_system
from ..ops import tridiag
from ..ops.tridiag import CyclicReductionSolver, _cr_solve_torch, cr_solve

SHAPES = ((1, 65536), (128, 8192), (8, 65536))
TILE_ROWS = (512, 1024, 2048, 4096, 8192)


def main():
    if not torch.cuda.is_available():
        raise SystemExit("cr_tile_sweep: no CUDA device is visible")
    dev = torch.device("cuda")
    print(f"device: {torch.cuda.get_device_name(dev)}; f32, hybrid cutoff 1023; "
          "us per solve for tiles of at least TILE_ROWS rows")
    floor, target = tridiag.TILE_ROWS, tridiag.TARGET_TILES
    gen = torch.Generator(device=dev).manual_seed(0)
    try:
        for lanes, n in SHAPES:
            sol = CyclicReductionSolver.from_tridiag(*tv_system(n, 1.0), dense_cutoff=1023,
                                                     device=dev, dtype=torch.float32)
            N = sol.alphas.shape[1]
            bb = torch.zeros((lanes, N), device=dev)
            bb[:, :n] = torch.randn((lanes, n), device=dev, generator=gen)
            ref = _cr_solve_torch(bb, sol)
            row = []
            for rows in TILE_ROWS:
                tridiag.TILE_ROWS, tridiag.TARGET_TILES = rows, 1 << 30  # the floor decides
                if not torch.equal(cr_solve(bb, sol), ref):
                    raise SystemExit(f"cr_tile_sweep: kernel != plain at {rows} rows")
                us = graph_ms(lambda: cr_solve(bb, sol), 200) * 1e3
                row.append(f"{rows}: {us:.1f}")
            print(f"B={lanes} n={n}:  " + "  ".join(row))
    finally:
        tridiag.TILE_ROWS, tridiag.TARGET_TILES = floor, target


if __name__ == "__main__":
    main()
