"""Where the host time of one collective goes: a one-rank process group
in this process, timing ``inner`` calls of each form on a float32 vector
of ``n`` floats (a consensus step's payload is 2n + 1 floats at its n):

  * ``direct``: ``torch.distributed.all_reduce`` alone;
  * ``psum``: ``Mesh.psum`` as every runner calls it (a ``cat`` and the
    same all_reduce on it);
  * ``psum_grad``: ``Mesh.psum(grad=True)`` as the implicit solvers'
    maps call it (the autograd Function and a ``clone`` besides);
  * ``chained``: ``Mesh.psum`` of a product of the previous call's
    result, so that each collective waits on a kernel and feeds the next
    (as in a step);
  * ``copies``: the ``cat`` and ``clone`` alone, no collective.

Each form runs ``inner`` calls back to back and then synchronises; the
host clock over the block, per call, is printed with the device time of
the same block from CUDA events (on the CPU the host clock only).  Each
call is made ``depth`` Python frames down (a runner's step calls its
collectives some 15 frames down, and a collective's host cost may grow
with the stack it records).  The environment's settings apply (for
example ``TORCH_FR_BUFFER_SIZE=0`` turns torch's flight recorder off).

Usage:  python -m admm_tpu_torch.experiments.collective_probe [--backend nccl|gloo]
            [--n 2049] [--inner 500] [--device cpu]
"""

from __future__ import annotations

import argparse
import json
import os
import tempfile
import time


def probe(backend=None, n=2049, inner=500, device=None, reps=3, depth=1):
    """One row per form: the best of ``reps`` blocks of ``inner`` calls,
    host us per call and, on the card, device us per call."""
    import torch

    from admm_tpu_torch.parallel import make_mesh
    from admm_tpu_torch.parallel import multihost

    rows = []
    with tempfile.TemporaryDirectory() as tmp:
        multihost.initialize_cluster(f"file://{tmp}/pg", 1, 0, backend=backend, device=device,
                                     timeout=120)
        try:
            rows = _time_forms(make_mesh(group=_world()), n, inner, reps, depth)
        finally:
            multihost.shutdown()
    for row in rows:
        row.update(backend=backend or ("gloo" if device == "cpu" else "nccl"), n=n,
                   inner=inner, depth=depth,
                   fr_buffer=os.environ.get("TORCH_FR_BUFFER_SIZE",
                                            os.environ.get("TORCH_NCCL_TRACE_BUFFER_SIZE")))
    return rows


def _world():
    import torch.distributed as dist

    return dist.group.WORLD


def _deep(fn, depth):
    """``fn`` wrapped to run ``depth`` - 1 Python frames further down."""
    if depth <= 1:
        return fn
    inner = _deep(fn, depth - 1)
    return lambda: inner()


def _time_forms(mesh, n, inner, reps, depth):
    import torch
    import torch.distributed as dist

    dev = mesh.device
    cuda = dev.type == "cuda"
    x = torch.randn(n, generator=torch.Generator().manual_seed(0)).to(dev)
    chain = [x]

    def chained():
        chain[0] = mesh.psum(chain[0] * 0.5)

    forms = {
        "direct": lambda: dist.all_reduce(x, group=mesh.group),
        "psum": lambda: mesh.psum(x),
        "psum_grad": lambda: mesh.psum(x, grad=True),
        "chained": chained,
        "copies": lambda: torch.cat([x.reshape(-1)]).clone(),
    }
    rows = []
    for name, call in forms.items():
        call = _deep(call, depth)
        for _ in range(10):
            call()
        best_host, best_dev = float("inf"), float("inf")
        for _ in range(reps):
            if cuda:
                torch.cuda.synchronize(dev)
                start, stop = (torch.cuda.Event(enable_timing=True) for _ in range(2))
                start.record()
            t0 = time.perf_counter()
            for _ in range(inner):
                call()
            if cuda:
                stop.record()
                torch.cuda.synchronize(dev)
                best_dev = min(best_dev, start.elapsed_time(stop) * 1e3 / inner)
            best_host = min(best_host, (time.perf_counter() - t0) * 1e6 / inner)
        rows.append({"form": name, "host_us_per_call": best_host,
                     "device_us_per_call": best_dev if cuda else None, "device": str(dev)})
    return rows


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--backend", default=None)
    ap.add_argument("--n", type=int, default=2049)
    ap.add_argument("--inner", type=int, default=500)
    ap.add_argument("--device", default=None)
    ap.add_argument("--depth", type=int, default=1)
    a = ap.parse_args(argv)
    for row in probe(a.backend, a.n, a.inner, a.device, depth=a.depth):
        print(json.dumps(row))


if __name__ == "__main__":
    main()
