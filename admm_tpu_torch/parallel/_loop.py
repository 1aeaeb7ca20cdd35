"""The results of a sharded solve, whole on every rank: the gathers of
the consensus and transpose-reduction runners over a mesh's ranks.  Their
loop is the engine's (``engine.run_steps``).
"""

from __future__ import annotations

import torch
from torch.utils import _pytree as pytree


def gather_tree(mesh, tree):
    """``tree`` (a dict of results, nested dicts and tuples allowed) with
    every tensor's dim-0 blocks gathered over ``mesh``'s ranks in one
    ``all_gather`` (``Mesh.gather``); unchanged without a group."""
    if mesh.group is None:
        return tree
    flat, spec = pytree.tree_flatten(tree)
    pos = [i for i, leaf in enumerate(flat) if isinstance(leaf, torch.Tensor)]
    whole = mesh.gather(*(flat[i] for i in pos))
    for i, t in zip(pos, whole if len(pos) > 1 else (whole,)):
        flat[i] = t
    return pytree.tree_unflatten(flat, spec)


def gather_lanes(mesh, layout, tree, sharded=()):
    """``tree``'s lanes whole on every rank, in one ``all_gather``: each
    rank holds the lanes of ``layout`` (``Mesh.lane_layout``), and the
    top-level keys in ``sharded`` hold its block of their shards on dim 1
    (dim 0 is the lanes).  With a lane row over one rank this is
    ``gather_tree``."""
    if layout.span == 1:
        return gather_tree(mesh, tree)
    keys = list(tree)
    flat, spec = pytree.tree_flatten([tree[k] for k in keys])
    owner = pytree.tree_flatten([pytree.tree_map(lambda _, k=k: k in sharded, tree[k])
                                 for k in keys])[0]
    pos = [i for i, leaf in enumerate(flat) if isinstance(leaf, torch.Tensor)]
    whole = mesh.gather(*(flat[i] for i in pos))
    q, rows = layout.span, mesh.shape[0]
    for i, t in zip(pos, whole if len(pos) > 1 else (whole,)):
        t = t.reshape((rows, q) + tuple(flat[i].shape))       # (rows, q, b, ...)
        if owner[i]:
            t = t.movedim(1, 2)                                # (rows, b, q, w, ...)
            flat[i] = t.reshape((rows * t.shape[1], q * t.shape[3]) + tuple(t.shape[4:]))
        else:
            flat[i] = t[:, 0].reshape((-1,) + tuple(flat[i].shape[1:]))
    return dict(zip(keys, pytree.tree_unflatten(flat, spec)))
