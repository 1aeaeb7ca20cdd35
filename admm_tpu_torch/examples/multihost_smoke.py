"""Multi-process smoke test (port of ``examples/multihost_smoke.py``).

Checks the wiring of ``parallel/multihost.py`` without a cluster: the
main process starts ``procs`` worker processes (``multihost.run_ranks``),
each joins one process group through ``initialize_cluster`` against a
rendezvous file, contributes its block of ``local_devices`` mesh
positions to the global mesh, and the ranks jointly run a sum over the
shard axis (``Mesh.psum``), the collective every sharded solver reduces
to.

The ranks run on the card by default, NCCL with one card per rank
(``procs`` at most the card count; more raises and names ``--backend
gloo``); ``--backend gloo`` lets every rank share the cards, and
``--device cpu`` runs gloo on the CPU.

Usage:  python -m admm_tpu_torch.examples.multihost_smoke [--procs 2] [--local-devices 2]
            [--device cuda|cpu] [--backend nccl|gloo]
"""

from __future__ import annotations

import argparse
import tempfile


def worker(process_id: int, num_processes: int, local_devices: int, count: int) -> None:
    """One rank, after ``initialize_cluster`` returned ``count``: sum every
    rank's block of the global (num_processes * local_devices, 4) array
    and check the total."""
    import torch
    import torch.distributed as dist

    from admm_tpu_torch.parallel.mesh import make_mesh

    if count != num_processes:
        raise RuntimeError(f"global device count {count} != {num_processes}")
    mesh = make_mesh(num_processes * local_devices, group=dist.group.WORLD)
    local = torch.full((local_devices, 4), float(process_id + 1), dtype=torch.float64,
                       device=mesh.device)
    got = float(mesh.psum(torch.sum(local)))
    want = float(sum((p + 1) * local_devices * 4 for p in range(num_processes)))
    if got != want:
        raise RuntimeError(f"global sum {got} != {want}")
    if process_id == 0:
        print(f"MULTIHOST OK: {num_processes} processes x {local_devices} mesh "
              f"positions on {mesh.device}, global psum = {got}", flush=True)


def main(procs: int = 2, local_devices: int = 2, device=None, backend=None,
         timeout: float = 300.0) -> int:
    """Run ``procs`` workers; returns 0 when every one succeeded."""
    import torch

    from admm_tpu_torch.device import resolve_device
    from admm_tpu_torch.parallel.multihost import run_ranks

    dev = resolve_device(device)
    cards = torch.cuda.device_count() if dev.type == "cuda" else 0
    if dev.type == "cuda" and backend in (None, "nccl") and procs > cards:
        raise ValueError(f"{procs} NCCL ranks need a card each and {cards} are visible; "
                         f"pass --backend gloo to run several ranks on one card")
    join = dict(device=None if device is None else str(device), backend=backend, timeout=120)
    code = ("from admm_tpu_torch.examples.multihost_smoke import worker\n"
            f"worker(rank, ranks, {int(local_devices)}, count)\n")
    with tempfile.TemporaryDirectory() as tmp:
        rc, outputs, _ = run_ranks(code, procs, tmp, timeout, join=join)
    for text in outputs:
        print(text.replace("DIST_INIT_OK\n", ""), end="")
    return 0 if rc == 0 else 1


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--procs", type=int, default=2)
    ap.add_argument("--local-devices", type=int, default=2)
    ap.add_argument("--device", default=None)
    ap.add_argument("--backend", default=None)
    a = ap.parse_args()
    raise SystemExit(main(a.procs, a.local_devices, a.device, a.backend))
