"""The shard mesh, stacked on one device or placed over processes, and
static row sharding (port of ``admm_tpu/parallel/mesh.py``).

``admm_tpu`` writes every sharded runner as one program over stacked
(W, ...) arrays and lets GSPMD place the leading axis on a device mesh.
Here a mesh is a small value naming that layout: ``shape`` (the mesh's
positions, or lanes x shards), ``axis_names``, the ``device`` of this
process and an optional ``torch.distributed`` process ``group``.

- Without a group (``make_mesh(n)``) every position lies on ``device``:
  W shards are dim 0 of one tensor, and a mean or sum over the mesh axis
  is a mean or sum over dim 0, as on ``admm_tpu``'s 8 virtual CPU
  devices.
- With a group of P ranks (``make_mesh(n, group=...)``,
  ``multihost.global_mesh``) each rank holds a contiguous block of W/P
  shards stacked on dim 0 of its own device (``Mesh.rows``), and every
  reduction over the shard axis is the rank's local reduction followed by
  one ``torch.distributed.all_reduce``.
- A 2-D (lanes x shards) mesh over P ranks is laid out as ``admm_tpu``'s
  process-major device grid: the grid flattened row-major, each rank a
  contiguous block of its positions (``make_mesh2d``).  Either the ranks
  divide the lanes (each rank its lanes, every shard of them), or the
  lanes divide the ranks and each lane row's shards span P/lanes ranks,
  whose shard-axis reductions run over that row's subgroup
  (``Mesh.lane_layout``).

Under ``torch.func.vmap`` (the lanes runner) a reduction over a group is
one collective for all the lanes: ``_AllReduceSum`` and ``_Bcast`` have
vmap rules that move the lane axis to the front and reduce the whole
(B, ...) tensor in one ``all_reduce``.

The runners reduce over the shard axis only through ``Mesh.psum``,
``Mesh.pmean`` and ``Mesh.gather``, so one code path serves both
layouts.  Without a group ``psum`` returns its arguments and ``pmean`` is
``torch.mean`` over dim 0, so a stacked solve computes what it computed
before the group existed, bit for bit.  Each call counts, in
``Mesh.stats``, the collective it is (or, without a group, would be)
and its payload bytes, and each collective issued over a group runs in
an ``admm_tpu_torch.collective`` span (``utils.profiling.span``; on the
card a collective's host call returns once NCCL's kernel is queued, and
its wait for the slowest rank shows as that kernel's device time).

The reference balances work with ``slicemaker`` (errorcheck.m:216-267):
N rows over W workers, remainder spread over the first slices.  Stacked
shards must be equal-sized, so rows are zero-padded up to the next
multiple of W — zero rows are exact no-ops for every Gram/matvec used by
the distributed solvers (D^T D, D^T s, D^T(z-u)).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, NamedTuple, Optional, Tuple

import numpy as np
import torch

from ..device import resolve_device
from ..utils.profiling import span

# The span of every collective a mesh issues (``utils.profiling.span``).
COLLECTIVE_SPAN = "admm_tpu_torch.collective"


def _new_stats():
    return {"calls": {}, "bytes": {}}


def _batched(t) -> bool:
    """Whether ``t`` is a lane of ``torch.func.vmap``."""
    return torch._C._functorch.is_batchedtensor(t)


def _payload(t) -> int:
    """The bytes a collective moves for ``t``: every lane of a tensor
    batched by ``torch.func.vmap``."""
    while _batched(t):
        t = torch._C._functorch.get_unwrapped(t)
    return t.numel() * t.element_size()


class _AllReduceSum(torch.autograd.Function):
    """A sum over a process group's ranks of each rank's part, to a value
    every rank holds whole.  Differentiated with the convention that a
    value every rank holds has its whole cotangent on every rank: the
    cotangent of each part is the sum's own (``_Bcast``)."""

    @staticmethod
    def forward(flat, group):
        import torch.distributed as dist

        out = flat.clone()
        with span(COLLECTIVE_SPAN):
            dist.all_reduce(out, group=group)
        return out

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.group = inputs[1]

    @staticmethod
    def backward(ctx, grad):
        return _Bcast.apply(grad, ctx.group), None

    @staticmethod
    def vmap(info, in_dims, flat, group):
        # All the lanes in one collective: the lane axis first, the whole
        # (B, ...) tensor reduced at once.
        d = in_dims[0]
        if d is None:
            return _AllReduceSum.apply(flat, group), None
        return _AllReduceSum.apply(flat.movedim(d, 0), group), 0


class _Bcast(torch.autograd.Function):
    """A value every rank holds whole, handed to a computation on this
    rank's shards: the identity, whose cotangent (each rank's part) is
    summed over the ranks (``_AllReduceSum``)."""

    @staticmethod
    def forward(t, group):
        return t.view_as(t)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.group = inputs[1]

    @staticmethod
    def backward(ctx, grad):
        return _AllReduceSum.apply(grad.contiguous(), ctx.group), None

    @staticmethod
    def vmap(info, in_dims, t, group):
        return _Bcast.apply(t, group), in_dims[0]


class LaneLayout(NamedTuple):
    """This rank's part of a lanes x shards solve (``Mesh.lane_layout``):
    its ``lanes`` and ``shards`` (slices of the B lanes and the W shards),
    the ``inner`` mesh the lanes' step reduces over (no group, or the lane
    row's subgroup), the ranks a lane row spans (``span``), and ``agree``:
    the chunk flags' minimum over the whole group, or None."""

    lanes: slice
    shards: slice
    inner: "Mesh"
    span: int
    agree: Optional[Callable]


@dataclasses.dataclass(frozen=True)
class Mesh:
    """Mesh positions stacked on one device, or placed over the ranks of a
    process group (the first axis over the ranks, in contiguous blocks)."""

    shape: Tuple[int, ...]
    axis_names: Tuple[str, ...]
    device: torch.device
    group: Any = None
    # A 2-D mesh whose lane rows span several ranks: this rank's lane
    # row's subgroup (``make_mesh2d``); None otherwise.
    lane_group: Any = dataclasses.field(default=None, compare=False, repr=False)
    # Collectives issued through this mesh (and its sub-meshes): calls and
    # payload bytes per operation; ``reset_stats`` empties it.
    stats: dict = dataclasses.field(default_factory=_new_stats, compare=False, repr=False)

    @property
    def size(self) -> int:
        """The number of mesh positions (lane-shard pairs on a 2-D mesh)."""
        return math.prod(self.shape)

    @property
    def world(self) -> int:
        """The ranks the mesh spans: 1 without a group."""
        if self.group is None:
            return 1
        import torch.distributed as dist

        return dist.get_world_size(self.group)

    @property
    def rank(self) -> int:
        """This process's rank in the group: 0 without one."""
        if self.group is None:
            return 0
        import torch.distributed as dist

        return dist.get_rank(self.group)

    def local(self) -> "Mesh":
        """The mesh without its group: what one rank holds, stacked, with
        counts of its own (its reductions are no collectives)."""
        return dataclasses.replace(self, group=None, lane_group=None, stats=_new_stats())

    def reset_stats(self) -> dict:
        """Empty the collective counts; returns the counts it held."""
        old = {k: dict(v) for k, v in self.stats.items()}
        for v in self.stats.values():
            v.clear()
        return old

    def rows(self, count: int, what: str = "shards") -> slice:
        """This rank's contiguous block of ``count`` stacked rows (shards,
        or lanes on a 2-D mesh): all of them without a group."""
        P = self.world
        if count % P:
            raise ValueError(f"{count} {what} must divide over the {P} ranks of the mesh's "
                             f"process group")
        per = count // P
        return slice(self.rank * per, (self.rank + 1) * per)

    def take(self, t, count: Optional[int] = None, what: str = "shards", dim: int = 0):
        """This rank's block of dim ``dim`` of ``t`` (the whole of it
        without a group); ``count`` defaults to the dim's size."""
        if self.group is None:
            return t
        rows = self.rows(t.shape[dim] if count is None else count, what)
        return t[(slice(None),) * (dim % t.ndim) + (rows,)]

    @property
    def span(self) -> int:
        """The ranks a lane row of a 2-D mesh spans: 1 unless the lanes
        divide the ranks (``make_mesh2d``)."""
        if self.group is None or len(self.shape) != 2:
            return 1
        return max(self.world // self.shape[0], 1)

    def lane_layout(self, Bn: int, W: int) -> LaneLayout:
        """This rank's part of B lanes of W shards each on this 2-D mesh.
        Without a group: everything, stacked.  With the ranks dividing the
        lanes: its block of lanes, every shard, an inner mesh without a
        group.  With a lane row over ``span`` ranks: the lanes of its row,
        its block of W/span shards, the row's subgroup as the inner mesh
        (its reductions count in this mesh's ``stats``), and ``agree``,
        which takes the chunk's ``(k, frozen)`` flags to their minimum over
        every rank, so that every rank leaves the chunk loop at once."""
        everything = slice(0, None)
        if self.group is None:
            return LaneLayout(everything, everything, self.local(), 1, None)
        q = self.span
        if q == 1:
            return LaneLayout(self.rows(Bn, "lanes"), everything, self.local(), 1, None)
        row, col = divmod(self.rank, q)
        per, ws = Bn // self.shape[0], W // q
        inner = Mesh((W,), (self.axis_names[1],), self.device, self.lane_group,
                     stats=self.stats)
        return LaneLayout(slice(row * per, (row + 1) * per), slice(col * ws, (col + 1) * ws),
                          inner, q, self.all_min)

    def all_min(self, t):
        """The elementwise minimum of ``t`` over every rank of the group,
        in one ``all_reduce`` (``t`` itself without a group)."""
        if self.group is None:
            return t
        import torch.distributed as dist

        self._count("all_reduce", _payload(t))
        t = t.clone()
        with span(COLLECTIVE_SPAN):
            dist.all_reduce(t, op=dist.ReduceOp.MIN, group=self.group)
        return t

    def _count(self, op: str, nbytes: int) -> None:
        calls, nb = self.stats["calls"], self.stats["bytes"]
        calls[op] = calls.get(op, 0) + 1
        nb[op] = nb.get(op, 0) + int(nbytes)

    def psum(self, *parts, grad: bool = False):
        """The sums over every rank of ``parts``, each this rank's partial
        sum (a tensor of any shape, all of one dtype), in one
        ``all_reduce``; without a group the parts themselves.  ``grad``:
        differentiable (``_AllReduceSum``), for an implicit solver's map;
        the runners' calls skip the Function's host cost.  Under
        ``torch.func.vmap`` the call is one ``all_reduce`` of every lane
        (``_AllReduceSum``'s vmap rule), counted once with every lane's
        bytes."""
        if self.group is None:
            self._count("all_reduce", sum(_payload(p) for p in parts))
            return parts if len(parts) > 1 else parts[0]
        flat = torch.cat([p.reshape(-1) for p in parts])
        self._count("all_reduce", _payload(flat))
        if grad or _batched(flat):
            flat = _AllReduceSum.apply(flat, self.group)
        else:
            import torch.distributed as dist

            with span(COLLECTIVE_SPAN):
                dist.all_reduce(flat, group=self.group)
        out, at = [], 0
        for p in parts:
            out.append(flat[at:at + p.numel()].reshape(p.shape))
            at += p.numel()
        return tuple(out) if len(out) > 1 else out[0]

    def bcast(self, t):
        """``t``, a value every rank holds whole, as the input of a
        computation on this rank's shards: the identity, and under autograd
        the cotangent summed over the ranks (so that the gradient of a
        whole value counts every rank's use of it once)."""
        return t if self.group is None else _Bcast.apply(t, self.group)

    def pmean(self, *stacks, grad: bool = False):
        """The means over the shard axis (dim 0, all W shards) of
        ``stacks``, in one ``all_reduce``: without a group ``torch.mean``
        over dim 0; with one, the ranks' local means summed and divided by
        the rank count (exact for a power of two, and for one rank the
        local mean itself).  ``grad`` as in ``psum``."""
        if self.group is None:
            self._count("all_reduce", sum(_payload(s[0]) for s in stacks))
            out = tuple(torch.mean(s, dim=0) for s in stacks)
            return out if len(out) > 1 else out[0]
        P = self.world
        sums = self.psum(*(torch.mean(s, dim=0) for s in stacks), grad=grad)
        sums = sums if len(stacks) > 1 else (sums,)
        out = tuple(s / P for s in sums) if P > 1 else sums
        return out if len(out) > 1 else out[0]

    def gather(self, *blocks):
        """The ranks' blocks of each tensor in ``blocks`` concatenated
        along dim 0 (rank order), in one ``all_gather``; without a group
        the blocks themselves.  Tensors of any dtype travel as float64,
        which holds every value of the port's float, int and bool state
        exactly."""
        nbytes = sum(b.numel() * 8 for b in blocks)
        self._count("all_gather", nbytes)
        if self.group is None:
            return blocks if len(blocks) > 1 else blocks[0]
        import torch.distributed as dist

        # gloo takes CUDA tensors here too (checked on the card by
        # chip_smoke.py (z18b), torch 2.11): nothing is staged by hand.
        flat = torch.cat([b.reshape(-1).to(torch.float64) for b in blocks])
        parts = [torch.empty_like(flat) for _ in range(self.world)]
        with span(COLLECTIVE_SPAN):
            dist.all_gather(parts, flat, group=self.group)
        out, at = [], 0
        for b in blocks:
            n = b.numel()
            whole = torch.cat([p[at:at + n].reshape(b.shape) for p in parts])
            out.append(whole.to(b.dtype))
            at += n
        return tuple(out) if len(out) > 1 else out[0]

    def barrier(self) -> None:
        """Wait for every rank (nothing without a group)."""
        if self.group is not None:
            import torch.distributed as dist

            self._count("barrier", 0)
            with span(COLLECTIVE_SPAN):
                dist.barrier(group=self.group)


def visible_devices(device) -> int:
    """How many devices of ``device``'s type are visible: the CUDA device
    count, or 1 for the CPU (torch runs the CPU as one device)."""
    device = torch.device(device)
    return torch.cuda.device_count() if device.type == "cuda" else 1


def _group_device(device, group):
    """The device of a mesh: ``device`` when given; over a process group
    this rank's device (``multihost.rank_device``); else the solve's
    default (``device.resolve_device``)."""
    if device is not None or group is None:
        return resolve_device(device)
    from .multihost import rank_device

    return rank_device()


def make_mesh(n_devices: Optional[int] = None, axis_name: str = "shards", *,
              device=None, group=None) -> Mesh:
    """A 1-D mesh of ``n_devices`` positions.  Without ``group`` they are
    stacked on ``device`` (default: the CUDA device,
    ``device.resolve_device``) and ``n_devices`` defaults to the number of
    visible devices of that type, as ``admm_tpu``'s defaults to
    ``jax.devices()``: 1 on one card, 1 on the CPU.  Over a process
    ``group`` of P ranks ``n_devices`` defaults to P and must be a
    multiple of it (each rank holds n/P positions), and ``device``
    defaults to this rank's device (``multihost.rank_device``)."""
    device = _group_device(device, group)
    if group is not None:
        import torch.distributed as dist

        P = dist.get_world_size(group)
        n = P if n_devices is None else int(n_devices)
        if n % P:
            raise ValueError(f"a mesh of {n} positions does not divide over the {P} ranks "
                             f"of its process group")
    else:
        n = visible_devices(device) if n_devices is None else int(n_devices)
    if n < 1:
        raise ValueError(f"a mesh needs at least one shard, got {n}")
    return Mesh((n,), (axis_name,), device, group)


def make_mesh2d(lanes: int, shards: int,
                axis_names: Tuple[str, str] = ("lanes", "shards"), *,
                device=None, group=None) -> Mesh:
    """A 2-D (lanes x shards) mesh: instance lanes on axis 0, consensus /
    transpose-reduction row shards on axis 1.

    Over a process ``group`` of P ranks the grid is laid out as
    ``admm_tpu``'s process-major device grid (``jax.devices()`` reshaped
    to (lanes, shards)): flattened row-major, each rank a contiguous block
    of lanes*shards/P positions.  Two layouts follow:

    - P divides ``lanes``: each rank holds lanes/P lane rows, every shard
      of them stacked on its device; a lanes step issues no collective.
    - ``lanes`` divides P and P/lanes divides ``shards``: each lane row's
      shards span P/lanes ranks, which reduce over the row's subgroup.
      The subgroups are made here, once, by every rank in the same order
      (``torch.distributed.new_group``); with one lane row the subgroup is
      ``group`` itself.

    Any other shape raises ``ValueError``."""
    if lanes < 1 or shards < 1:
        raise ValueError(f"mesh {lanes}x{shards} needs positive sizes")
    device = _group_device(device, group)
    lane_group = None
    if group is not None:
        import torch.distributed as dist

        P = dist.get_world_size(group)
        if lanes % P:
            q = P // lanes
            if P % lanes or shards % q:
                raise ValueError(
                    f"a {lanes}x{shards} mesh does not lay out over the {P} ranks of its "
                    f"process group: the ranks must divide the lanes (each rank whole lane "
                    f"rows), or the lanes must divide the ranks and the ranks of a lane row "
                    f"({P}/lanes) divide the shards (each lane row's shards over a subgroup)")
            if lanes == 1:
                lane_group = group
            else:
                ranks = dist.get_process_group_ranks(group)
                me = dist.get_rank(group)
                for r in range(lanes):
                    sub = dist.new_group(ranks[r * q:(r + 1) * q])
                    if r == me // q:
                        lane_group = sub
    return Mesh((int(lanes), int(shards)), tuple(axis_names), device, group,
                lane_group=lane_group)


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
    if ndim == 2:
        import torch.distributed as dist

        if dist.is_available() and dist.is_initialized():
            # admm_tpu's default over a cluster: 1 lane x every device of
            # every process, the shard axis over the ranks.
            group = dist.group.WORLD
            mesh = make_mesh2d(1, dist.get_world_size(group), device=device, group=group)
            return mesh, mesh.device
        device = resolve_device(device, *operands)
        return make_mesh2d(1, visible_devices(device), device=device), device
    device = resolve_device(device, *operands)
    return make_mesh(device=device), device


def shard_count(mesh: Mesh, nshards: Optional[int]):
    """``(W, mesh)`` of a 1-D sharded solve, with ``admm_tpu``'s rules over
    the stacked mesh: W defaults to the mesh size; fewer shards than the
    mesh gives a sub-mesh of the first W (not over a process group); more
    must be a multiple of it.  The sub-mesh shares the mesh's counts."""
    W = mesh.size if nshards is None else int(nshards)
    if W < mesh.size:
        if mesh.group is not None:
            raise ValueError(f"nshards={W} is fewer than the {mesh.size} positions of a mesh "
                             f"over a process group; a sub-mesh would leave ranks without "
                             f"shards")
        mesh = dataclasses.replace(mesh, shape=(W,))
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
