"""Multi-host cluster initialization (the names of
``admm_tpu/parallel/multihost.py``).

Placing the shard axis over processes with ``torch.distributed`` is
ROADMAP.md queue 1, slice 10b; until then both names raise.  The stacked
mesh of ``mesh.make_mesh`` runs every sharded solver on one device.
"""

from __future__ import annotations

from typing import Optional


def initialize_cluster(coordinator_address: Optional[str] = None,
                       num_processes: Optional[int] = None,
                       process_id: Optional[int] = None) -> int:
    """Join a multi-process cluster: not ported yet (slice 10b)."""
    raise NotImplementedError(
        "admm_tpu_torch.parallel.initialize_cluster: placing the shard axis over "
        "processes is ROADMAP.md queue 1, slice 10b, which is not ported yet")


def global_mesh(axis_name: str = "shards"):
    """A mesh over every device of a cluster: not ported yet (slice 10b)."""
    raise NotImplementedError(
        "admm_tpu_torch.parallel.global_mesh: a mesh over a cluster's devices is "
        "ROADMAP.md queue 1, slice 10b, which is not ported yet")
