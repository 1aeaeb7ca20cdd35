"""Checkpoint / resume of ADMM solver state (port of
``admm_tpu/utils/checkpoint.py``, its npz half).

The state (x, z, u, rho, steps) is written to a ``.npz`` with the same
keys as ``admm_tpu``'s, so a state saved by either package resumes in the
other: the arrays land on the host as numpy, and ``load_state`` gives them
back as numpy warm-start arguments (x0/z0/u0) for any entry point, which
places them on its own device.

``save_state_orbax`` and ``load_state_orbax`` keep ``admm_tpu``'s names
and fields (the state plus the per-shard ``xi``/``ui`` of
``results.extra``) in a sharded format of the port's own (orbax is not a
dependency): the path is a directory in which each rank of the solve's
mesh writes its block of the per-shard state (dim 0: the shards of a
consensus solve, the lanes of a lanes x shards batch) to
``block-<rank>.npz``, and rank 0 writes the replicated fields and the
block count to ``state.npz``.  Loading concatenates the blocks, so the
state resumes on any number of ranks: each takes its own block again.
"""

from __future__ import annotations

from pathlib import Path
from typing import Union

import numpy as np

from ..results import ADMMResults


def _npz_path(path: Union[str, Path]) -> Path:
    """np.savez appends '.npz' when missing; normalize both sides so a
    save/load round-trip with the same extensionless path works."""
    path = Path(path)
    return path if path.suffix == ".npz" else path.with_suffix(path.suffix + ".npz")


def _host(v):
    return np.asarray(v.detach().cpu().numpy() if hasattr(v, "detach") else v)


def save_state(results: ADMMResults, path: Union[str, Path]) -> None:
    """Persist the resumable state of a solve (as <path>.npz if the
    suffix is missing, np.savez's rule); tensors are copied to the host."""
    np.savez(
        Path(path),
        x=_host(results.xopt),
        z=_host(results.zopt),
        u=_host(results.uopt),
        rho=_host(results.rho_final),
        steps=_host(results.steps),
    )


def load_state(path: Union[str, Path]) -> dict:
    """Load a saved state as warm-start kwargs (x0/z0/u0, numpy arrays)
    plus the rho and step count at save time."""
    with np.load(_npz_path(path)) as f:
        return {
            "x0": f["x"],
            "z0": f["z"],
            "u0": f["u"],
            "rho": float(f["rho"]),
            "steps": int(f["steps"]),
        }


def _mesh_of(results):
    mesh = getattr(results, "extra", {}).get("mesh")
    return mesh if mesh is not None and getattr(mesh, "group", None) is not None else None


def save_state_orbax(results: ADMMResults, path: Union[str, Path]) -> None:
    """Persist a solve's state with its per-shard state (``extra['xi']``,
    ``extra['ui']``) as a sharded checkpoint directory; takes
    ``ADMMResults`` and the lanes' ``BatchResults`` (a None ``rho_final``
    is saved as 1.0, and ``steps`` may be per lane).  Over a process group
    every rank of the results' mesh calls it: each writes its block."""
    path = Path(path).absolute()
    mesh = _mesh_of(results)
    rank, ranks = (0, 1) if mesh is None else (mesh.rank, mesh.world)
    path.mkdir(parents=True, exist_ok=True)
    blocks = {}
    for key in ("xi", "ui"):
        if key in results.extra:
            whole = _host(results.extra[key])
            per = whole.shape[0] // ranks
            blocks[key] = whole[rank * per:(rank + 1) * per]
    if blocks:
        np.savez(path / f"block-{rank}.npz", **blocks)
    if mesh is not None:
        mesh.barrier()
    if rank == 0:
        rho = results.rho_final
        np.savez(path / "state.npz", x=_host(results.xopt), z=_host(results.zopt),
                 u=_host(results.uopt), rho=np.asarray(1.0 if rho is None else _host(rho)),
                 steps=_host(results.steps), blocks=np.asarray(ranks if blocks else 0))
    if mesh is not None:
        mesh.barrier()


def load_state_orbax(path: Union[str, Path]) -> dict:
    """Restore a checkpoint written by ``save_state_orbax``: warm-start
    kwargs like ``load_state`` (numpy arrays; ``rho`` and ``steps`` as
    numbers for one solve, arrays for lanes) plus the whole per-shard
    ``xi``/``ui`` when present, whatever rank count wrote them."""
    path = Path(path).absolute()
    with np.load(path / "state.npz") as f:
        state = {k: f[k] for k in f.files}
    rho, steps = state["rho"], state["steps"]
    out = {"x0": state["x"], "z0": state["z"], "u0": state["u"],
           "rho": float(rho) if rho.ndim == 0 else rho,
           "steps": int(steps) if steps.ndim == 0 else steps}
    parts = []
    for r in range(int(state["blocks"])):
        with np.load(path / f"block-{r}.npz") as f:
            parts.append({k: f[k] for k in f.files})
    for key in (parts[0] if parts else {}):
        out[key] = np.concatenate([p[key] for p in parts])
    return out
