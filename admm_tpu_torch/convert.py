"""Problem state carried across from ``admm_tpu`` to the port.

``admm_tpu``'s LASSO setup leaves its operands in a ``data`` dict of JAX
arrays and solver objects.  ``numpy_state`` flattens such a dict into
plain numpy arrays (duck-typed: it never imports JAX), and
``lasso_data`` rebuilds the port's ``data`` dict from them on a given
device.  Feeding the same numbers to both packages this way isolates the
iteration from differences in the setup-time linear algebra (eigh,
solve), which is what the parity tests need.

Flat keys: ``D``, ``s``, ``Dts``, ``lam``; the static-rho solver, as
``fat.D``/``fat.E``/``fat.rho0`` (``FatShiftSolver``, fat D) or ``Minv``
(skinny D); and optionally the warm start ``x0``, ``z0``, ``u0``.
"""

from __future__ import annotations

import numpy as np
import torch

from .ops.solve import FatShiftSolver

_ARRAYS = ("D", "s", "Dts", "lam", "Minv")
_FAT_FIELDS = ("D", "E", "rho0")


def numpy_state(data: dict, **warm) -> dict:
    """Flatten a static-rho LASSO ``data`` dict (of either package) plus
    optional ``x0``/``z0``/``u0`` arrays into ``{flat key: numpy array}``."""
    state = {}
    for key, val in data.items():
        if key == "fat":
            state.update({f"fat.{f}": _np(getattr(val, f)) for f in _FAT_FIELDS})
        elif key in _ARRAYS:
            state[key] = _np(val)
        else:
            raise ValueError(
                f"numpy_state: no conversion for data[{key!r}]; only the "
                "static-rho LASSO state is carried across")
    state.update({k: _np(v) for k, v in warm.items() if v is not None})
    return state


def lasso_data(state: dict, *, device="cpu", dtype=None):
    """Build ``(data, warm)`` for the port from a flat numpy ``state``:
    ``data`` is the dict the port's LASSO proxes take and ``warm`` holds
    the warm-start tensors ``x0``/``z0``/``u0`` present in the state.
    Every tensor lands on ``device`` in ``dtype`` (default: D's dtype)."""
    device = torch.device(device)
    if dtype is None:
        dtype = torch.from_numpy(np.zeros(0, state["D"].dtype)).dtype

    def t(key):
        return torch.tensor(state[key], dtype=dtype, device=device)

    data = {k: t(k) for k in _ARRAYS if k in state}
    if "fat.E" in state:
        data["fat"] = FatShiftSolver(*(t(f"fat.{f}") for f in _FAT_FIELDS))
    warm = {k: t(k) for k in ("x0", "z0", "u0") if k in state}
    return data, warm


def _np(v):
    if isinstance(v, torch.Tensor):
        return v.detach().cpu().numpy()
    return np.array(v)
