"""Checkpoint / resume of ADMM solver state (port of
``admm_tpu/utils/checkpoint.py``, its npz half).

The state (x, z, u, rho, steps) is written to a ``.npz`` with the same
keys as ``admm_tpu``'s, so a state saved by either package resumes in the
other: the arrays land on the host as numpy, and ``load_state`` gives them
back as numpy warm-start arguments (x0/z0/u0) for any entry point, which
places them on its own device.  The orbax backend for sharded state
(``save_state_orbax``, ``load_state_orbax``) waits for sharded
checkpoints (ROADMAP.md queue 1, slice 10b) and raises.
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


def _slice10(name):
    return NotImplementedError(
        f"admm_tpu_torch.utils.{name}: the orbax backend for sharded solver state "
        "comes with sharded checkpoints (ROADMAP.md queue 1, slice 10b); use "
        "save_state/load_state (npz)")


def save_state_orbax(results: ADMMResults, path: Union[str, Path]) -> None:
    """Not ported yet (sharded state, slice 10b): raises."""
    raise _slice10("save_state_orbax")


def load_state_orbax(path: Union[str, Path]) -> dict:
    """Not ported yet (sharded state, slice 10b): raises."""
    raise _slice10("load_state_orbax")
