"""The shard mesh on one device, and static row sharding (port of
``admm_tpu/parallel/mesh.py``).

``admm_tpu`` writes every sharded runner as one program over stacked
(W, ...) arrays and lets GSPMD place the leading axis on a device mesh.
Here a mesh is a small value naming that stacked layout: ``shape`` (the
shard count, or lanes x shards), ``axis_names`` and the ``device`` that
holds every shard.  A mean or sum over the mesh axis is a mean or sum
over dim 0 of a tensor on that device, so W shards run on one card as
they run on ``admm_tpu``'s 8 virtual CPU devices; placing the shard axis
over processes is ROADMAP.md queue 1, slice 10b.

The reference balances work with ``slicemaker`` (errorcheck.m:216-267):
N rows over W workers, remainder spread over the first slices.  Stacked
shards must be equal-sized, so rows are zero-padded up to the next
multiple of W — zero rows are exact no-ops for every Gram/matvec used by
the distributed solvers (D^T D, D^T s, D^T(z-u)).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple

import numpy as np
import torch

from ..device import resolve_device


@dataclasses.dataclass(frozen=True)
class Mesh:
    """W stacked shards (or lanes x shards) on one device."""

    shape: Tuple[int, ...]
    axis_names: Tuple[str, ...]
    device: torch.device

    @property
    def size(self) -> int:
        """The number of shards (of lane-shard pairs on a 2-D mesh)."""
        return math.prod(self.shape)


def visible_devices(device) -> int:
    """How many devices of ``device``'s type are visible: the CUDA device
    count, or 1 for the CPU (torch runs the CPU as one device)."""
    device = torch.device(device)
    return torch.cuda.device_count() if device.type == "cuda" else 1


def make_mesh(n_devices: Optional[int] = None, axis_name: str = "shards", *,
              device=None) -> Mesh:
    """A 1-D mesh of ``n_devices`` stacked shards on ``device`` (default:
    the CUDA device, ``device.resolve_device``).  ``n_devices`` defaults
    to the number of visible devices of that type, as ``admm_tpu``'s
    defaults to ``jax.devices()``: 1 on one card, 1 on the CPU."""
    device = resolve_device(device)
    n = visible_devices(device) if n_devices is None else int(n_devices)
    if n < 1:
        raise ValueError(f"a mesh needs at least one shard, got {n}")
    return Mesh((n,), (axis_name,), device)


def make_mesh2d(lanes: int, shards: int,
                axis_names: Tuple[str, str] = ("lanes", "shards"), *,
                device=None) -> Mesh:
    """A 2-D (lanes x shards) mesh on ``device``: instance lanes on axis 0,
    consensus / transpose-reduction row shards on axis 1."""
    if lanes < 1 or shards < 1:
        raise ValueError(f"mesh {lanes}x{shards} needs positive sizes")
    return Mesh((int(lanes), int(shards)), tuple(axis_names), resolve_device(device))


def pad_rows(M, multiple: int):
    """Zero-pad axis 0 of ``M`` (numpy array or tensor) to a multiple;
    returns (padded, n_pad)."""
    m = M.shape[0]
    n_pad = math.ceil(m / multiple) * multiple - m
    if n_pad == 0:
        return M, 0
    if isinstance(M, torch.Tensor):
        return torch.cat((M, M.new_zeros((n_pad,) + tuple(M.shape[1:])))), n_pad
    return np.pad(M, [(0, n_pad)] + [(0, 0)] * (M.ndim - 1)), n_pad


def shard_rows(M, W: int):
    """Reshape rows into W equal contiguous blocks: (m, ...) -> (W, m/W, ...)
    (numpy arrays stay numpy, tensors stay tensors); combine with
    ``pad_rows`` first."""
    if not isinstance(M, torch.Tensor):
        M = np.asarray(M)
    m = M.shape[0]
    if m % W:
        raise ValueError(f"rows {m} not divisible by {W}; pad_rows first")
    return M.reshape((W, m // W) + tuple(M.shape[1:]))


def resolve_mesh(mesh: Optional[Mesh], device, *operands, ndim: int = 1):
    """``(mesh, device)`` of a sharded solve: the mesh's device when a mesh
    is given (``device``, when also given, must be of its type), else
    ``device.resolve_device(device, *operands)`` and the default mesh
    there (``make_mesh``, or 1 lane x all devices for ``ndim=2``)."""
    if mesh is not None:
        if device is not None and torch.device(device).type != mesh.device.type:
            raise ValueError(f"device={device!r} differs from the mesh's {mesh.device}")
        return mesh, mesh.device
    device = resolve_device(device, *operands)
    if ndim == 2:
        return make_mesh2d(1, visible_devices(device), device=device), device
    return make_mesh(device=device), device


def shard_count(mesh: Mesh, nshards: Optional[int]):
    """``(W, mesh)`` of a 1-D sharded solve, with ``admm_tpu``'s rules over
    the stacked mesh: W defaults to the mesh size; fewer shards than the
    mesh gives a sub-mesh of the first W; more must be a multiple of it."""
    W = mesh.size if nshards is None else int(nshards)
    if W < mesh.size:
        mesh = make_mesh(W, mesh.axis_names[0], device=mesh.device)
    elif W % mesh.size:
        raise ValueError(f"nshards={W} must be a multiple of the mesh size {mesh.size}")
    return W, mesh


def lane_shard_count(mesh: Mesh, nshards: Optional[int], Bn: int, what: str):
    """``W`` of a lanes x shards solve of ``Bn`` lanes on a 2-D mesh, with
    ``admm_tpu``'s checks (a 2-D mesh; W a multiple of its shard axis; the
    lanes divide over its lane axis)."""
    if len(mesh.axis_names) != 2:
        raise ValueError(f"{what} needs a 2-D (lanes, shards) mesh; got axes {mesh.axis_names}")
    L, Wdev = mesh.shape
    W = Wdev if nshards is None else int(nshards)
    if W % Wdev:
        raise ValueError(f"nshards={W} must be a multiple of the mesh shard-axis size {Wdev}")
    if Bn % L:
        raise ValueError(f"batch size {Bn} must divide over the {L}-device lane axis")
    return W
