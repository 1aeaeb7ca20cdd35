"""Engine-generic sliced proximal updates (port of
``admm_tpu/parallel/sliced.py``).

The reference's ``options.parallel in {'xminf','zming','both'}`` wraps the
user prox in parproxf/parproxg, parfor-ing over user-declared slices of
the variable with the full (x, z, u) broadcast to each worker and the
slice results gathered via cell2mat (admm.m:343-467); slice vectors are
validated and worker-balanced by errorcheck('slices') -> slicemaker
(errorcheck.m:216-267), and 'both' takes a 2-element cell (slicesx,
slicesz) (admm.m:360-383).

The same contract — a per-slice prox ``prox_slice(x, z, u, rho, k) ->
slice k of the result`` — runs here on one device: the W slices of the
mesh are computed in one pass over k = 0..W-1 (each call sees the full
iterates), and a static gather map reassembles their blocks into the flat
result, ``admm_tpu``'s shard_map out-spec and cell2mat gather.  UNEVEN
slices pad each block to the longest (the map drops the padding); a slice
of length 0 (fewer slices than the mesh has shards) is not computed.  The
result is a plain ``prox(x, z, u, rho)`` for the core engine, so slicing
composes with every engine feature.

Over a mesh with a process group each rank computes the slices of its
block of mesh positions (zeros for a position without a slice), and one
``all_gather`` of the (W, L) blocks hands every rank the whole update;
the engine around the prox runs whole on every rank.
"""

from __future__ import annotations

from typing import Callable, Optional, Sequence, Union

import numpy as np
import torch

from ..utils.validate import slicemaker
from .mesh import Mesh, make_mesh


def make_sliced_prox(prox_slice: Callable, slices: Union[int, Sequence[int]],
                     mesh: Optional[Mesh] = None) -> Callable:
    """Build an engine-compatible prox from a per-slice prox.

    ``prox_slice(x, z, u, rho, k)`` receives the FULL iterates and the
    slice index k, a Python int (the reference's xminfi(x, z, u, rho, k)
    contract, admm.m:416-436).  Each call builds a new wrapper: the port
    compiles nothing, so there is no runner cache to keep warm.

    ``slices`` is an int — every one of the mesh's W slices has that
    length (the per-slice result has shape ``(slices,)``) — or a sequence
    of at most W per-slice lengths (possibly uneven, e.g. from
    ``slicemaker``); the per-slice result then has shape ``(max(slices),)``
    with only its first ``lengths[k]`` entries meaningful.  ``mesh``
    defaults to ``make_mesh()``.
    """
    if mesh is None:
        mesh = make_mesh()
    W = mesh.size
    if np.ndim(slices) == 0:
        if int(slices) <= 0:
            # 0 means 'even split' only where slicemaker resolves it first
            # (make_parallel_proxes / admm(parallel=)); here a scalar is the
            # per-slice LENGTH and must be positive.
            raise ValueError(
                "make_sliced_prox scalar slices is the per-slice length and must be "
                "positive; for an even split pass slicemaker(0, n, W) lengths or use "
                "make_parallel_proxes")
        lengths = [int(slices)] * W
    else:
        lengths = [int(v) for v in slices]
        if len(lengths) > W:
            # admm_tpu's rule, over the mesh's shards: one slice per shard
            # (the reference's parfor queues any count, admm.m:430-434).
            raise ValueError(
                f"{len(lengths)} slices > {W} mesh devices: each shard computes exactly "
                f"one slice per step. Pass a vector of at most {W} lengths "
                f"(slicemaker(0, n, {W}) builds a mesh-balanced even split)")
    L = max(lengths)
    if mesh.group is not None:
        return _sliced_over_ranks(prox_slice, lengths + [0] * (W - len(lengths)), L, mesh)
    live = [k for k, length in enumerate(lengths) if length]
    # Static gather map: entry j of the flat result lives at block b's
    # offset o, position b*L + o of the stacked (len(live), L) blocks.
    idx = np.concatenate([b * L + np.arange(lengths[k]) for b, k in enumerate(live)])
    even = all(lengths[k] == L for k in live)
    idx_of = {}

    def prox(x, z, u, rho):
        stacked = torch.stack([prox_slice(x, z, u, rho, k).reshape(L) for k in live])
        if even:
            return stacked.reshape(-1)
        dev = stacked.device
        if dev not in idx_of:
            idx_of[dev] = torch.as_tensor(idx, dtype=torch.int64, device=dev)
        return stacked.reshape(-1).index_select(0, idx_of[dev])

    return prox


def _sliced_over_ranks(prox_slice, lengths, L, mesh):
    """``make_sliced_prox`` over a process group: this rank's slices, the
    (W, L) blocks gathered, the live entries selected."""
    idx = np.concatenate([k * L + np.arange(n) for k, n in enumerate(lengths) if n])
    mine = range(*mesh.rows(len(lengths)).indices(len(lengths)))
    idx_of = {}

    def prox(x, z, u, rho):
        blocks = torch.stack([
            prox_slice(x, z, u, rho, k).reshape(L) if lengths[k]
            else torch.zeros(L, dtype=x.dtype, device=x.device) for k in mine])
        stacked = mesh.gather(blocks).reshape(-1)
        dev = stacked.device
        if dev not in idx_of:
            idx_of[dev] = torch.as_tensor(idx, dtype=torch.int64, device=dev)
        return stacked.index_select(0, idx_of[dev])

    return prox


def make_parallel_proxes(prox_f: Callable, prox_g: Callable, parallel: str, slices,
                         nx: Optional[int] = None, nz: Optional[int] = None,
                         mesh: Optional[Mesh] = None):
    """Wire the reference's ``options.parallel`` modes (admm.m:343-467).

    - ``parallel='xminf'``: ``prox_f`` is the per-slice xminfi; returns
      (wrapped_f, prox_g).  ``slices`` is a slicemaker spec (scalar k, 0
      for an even split over the mesh's shards, or a vector of lengths)
      over ``nx``.
    - ``parallel='zming'``: symmetric, over ``nz``.
    - ``parallel='both'``: ``slices`` is a 2-tuple (slicesx, slicesz);
      both proxes are per-slice.

    Returns ``(prox_f, prox_g)`` for ``admm(...)``.  A spec must give at
    most one slice per shard of the mesh (``mesh`` defaults to
    ``make_mesh()``).
    """
    if parallel not in ("xminf", "zming", "both"):
        raise ValueError(f"parallel must be 'xminf'|'zming'|'both', got {parallel!r}")
    if mesh is None:
        mesh = make_mesh()
    W = mesh.size

    if parallel == "both":
        if not (isinstance(slices, (tuple, list)) and len(slices) == 2):
            raise ValueError("parallel='both' needs slices=(slicesx, slicesz) — the "
                             "reference's 2-element cell (admm.m:360-365)")
        slicesx, slicesz = slices
    elif isinstance(slices, (tuple, list)) and len(slices) == 2 and all(
            np.ndim(s) != 0 for s in slices):
        raise ValueError("a 2-element slices pair is only valid with parallel='both' "
                         "(admm.m:365-368)")
    else:
        slicesx = slices if parallel == "xminf" else None
        slicesz = slices if parallel == "zming" else None

    if parallel in ("xminf", "both"):
        if nx is None:
            raise ValueError("nx (length of x) is required to slice xminf")
        prox_f = make_sliced_prox(prox_f, slicemaker(0 if slicesx is None else slicesx, nx, W),
                                  mesh)
    if parallel in ("zming", "both"):
        if nz is None:
            raise ValueError("nz (length of z) is required to slice zming")
        prox_g = make_sliced_prox(prox_g, slicemaker(0 if slicesz is None else slicesz, nz, W),
                                  mesh)
    return prox_f, prox_g
