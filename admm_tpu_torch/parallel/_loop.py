"""The chunk loop that every sharded runner shares.

``admm_tpu``'s consensus, transpose-reduction and exchange runners are
each one ``lax.while_loop`` over ``unrolled_body``: K freeze-masked
sub-steps per trip, history writes dropped past the end when frozen.  The
port runs them as the engine runs its step (``engine._run_chunks``):
chunks of K sub-steps on the device, the host reading ``(k, done)`` once
per chunk and nowhere else.  At every sub-step of an unrolled chunk (and
of every chunk of lanes) ``frozen = done | k >= N`` selects the old state
against the new one and sends the sub-step's history writes to a spare
slot N past the end, so results, steps and histories equal K = 1.

A runner's ``step(s, bufs, data, frozen, slot, put)`` takes its state
``s`` (a dict of tensors holding at least ``k`` and ``done``), its
buffers (history and the like), the solve's data, the freeze flag (None
when nothing can be frozen), the history slot (a 1-element int64 index,
N when frozen) and ``put(buf, dim, slot, rows)``, the buffer write (in
place on one instance, out of place under vmap), and returns the new
state and the buffers.
"""

from __future__ import annotations

import torch
from torch.utils import _pytree as pytree

from .. import engine
from ..engine import _put_in_place, _put_new


def history(names, N, lead, dtype, device):
    """The scalar-trace buffer: one row per name, column N the spare slot."""
    return torch.full(tuple(lead) + (len(names), N + 1), float("nan"), dtype=dtype,
                      device=device)


def traces(names, bufs, N, lanes=False):
    """The ``hist`` dict of a result: each scalar trace and each other
    buffer but the Anderson rings, cut to N."""
    hist = bufs["hist"]
    out = {name: hist[..., i, :N] for i, name in enumerate(names)}
    out.update({name: buf[:, :N] if lanes else buf[:N] for name, buf in bufs.items()
                if name not in ("hist", "aF", "aT")})
    return out


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


def run_loop(step, state, bufs, data, N, K, data_dims=None, agree=None):
    """Run ``step`` in chunks of K sub-steps until done or N steps; returns
    the final ``(state, bufs)``.  With ``data_dims`` (``data``'s keys: 0
    for a leaf stacked over lanes, None for a shared one) the state and
    buffers carry a leading lane axis and the sub-step runs under
    ``torch.func.vmap``; the lanes run until every one is frozen.
    ``agree`` (lanes whose shards span ranks: ``Mesh.all_min``) takes the
    chunk's flags to their minimum over every rank, so that all ranks
    leave the loop after the same chunk."""
    lanes = data_dims is not None
    freeze = K > 1 or lanes
    put = _put_new if lanes else _put_in_place
    spare = torch.tensor(N, dtype=torch.int64, device=state["k"].device)

    def sub(s, b, d):
        frozen = (s["done"] | (s["k"] >= N)) if freeze else None
        slot = (s["k"] if frozen is None else torch.where(frozen, spare, s["k"])).reshape(1)
        new, b = step(s, dict(b), d, frozen, slot, put)
        if frozen is not None:
            new = {key: torch.where(frozen, s[key], val) for key, val in new.items()}
        return new, b

    if lanes:
        run = torch.func.vmap(sub, in_dims=(0, 0, data_dims))
        def flags():
            s = cur[0]
            f = torch.stack((s["k"].min(), (s["done"] | (s["k"] >= N)).all().long()))
            return f if agree is None else agree(f)
    else:
        run = sub
        flags = lambda: torch.stack((cur[0]["k"], cur[0]["done"].long()))  # noqa: E731
    cur = [state, bufs]

    def one():
        cur[0], cur[1] = run(cur[0], cur[1], data)

    # Looked up on the module: a caller may wrap it (chip_smoke.py counts
    # the synchronising calls per sub-step that way).
    engine._run_chunks(one, flags, N, K)
    return cur

