"""Multi-process cluster initialization (port of
``admm_tpu/parallel/multihost.py``).

``admm_tpu`` joins hosts with ``jax.distributed``, after which its meshes
span every device of the cluster.  The port joins processes with
``torch.distributed``: every process calls ``initialize_cluster()``
before it solves, and ``global_mesh()`` then places the shard axis of
every sharded runner over the ranks (``mesh.Mesh`` with a process group:
each rank holds a contiguous block of shards on its own device, and each
reduction over the shard axis is one ``all_reduce``).

Launch one process per rank, for example with torchrun, whose
environment (``RANK``, ``WORLD_SIZE``, ``MASTER_ADDR``, ``MASTER_PORT``,
``LOCAL_RANK``) ``initialize_cluster`` reads when its arguments are not
given::

    torchrun --nproc-per-node 2 my_solve.py      # my_solve.py:
    from admm_tpu_torch.parallel import consensus_lasso, global_mesh, initialize_cluster
    initialize_cluster()                         # NCCL, cuda:LOCAL_RANK
    res = consensus_lasso(D, s, lam, mesh=global_mesh(), nshards=8)

The backend is NCCL on the card and gloo on the CPU (``device="cpu"``);
gloo may also carry CUDA tensors, so several ranks can share one card
under ``backend="gloo"``.  NCCL refuses two ranks on one card, and so
does ``initialize_cluster``, naming ``backend="gloo"``: it never switches
backend on its own.  A group made outside ``initialize_cluster`` puts its
meshes on the card too, unless they are given ``device="cpu"``.

``run_ranks`` starts a few ranks on this machine, joined by a file
rendezvous, and collects their exit code, output and saved arrays: the
launcher of ``examples/multihost_smoke.py``, the multi-process tests and
``chip_smoke.py``'s two-rank phases.
"""

from __future__ import annotations

import datetime
import os
import subprocess
import sys
import textwrap
import time
from pathlib import Path
from typing import Optional

import numpy as np
import torch

from ..device import resolve_device

# How long a collective may wait for the other ranks before it fails: a
# rank that stopped issuing collectives (a differing stop decision) makes
# the others fail instead of hanging.
DEFAULT_TIMEOUT_S = 300.0

# This process's device, set by ``initialize_cluster``.
_RANK_DEVICE: dict = {}


def _env_int(name: str) -> Optional[int]:
    v = os.environ.get(name)
    return None if v in (None, "") else int(v)


def _init_method(coordinator_address: Optional[str]) -> str:
    if coordinator_address is None:
        addr = os.environ.get("MASTER_ADDR")
        port = os.environ.get("MASTER_PORT")
        if addr is None or port is None:
            raise ValueError(
                "initialize_cluster needs coordinator_address ('host:port', 'tcp://...' or "
                "'file://...') or torchrun's MASTER_ADDR and MASTER_PORT")
        return f"tcp://{addr}:{port}"
    if "://" in coordinator_address:
        return coordinator_address
    return f"tcp://{coordinator_address}"


def initialize_cluster(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    *,
    backend: Optional[str] = None,
    device=None,
    timeout: float = DEFAULT_TIMEOUT_S,
) -> int:
    """Join a cluster of ``num_processes`` processes as rank
    ``process_id`` (``admm_tpu``'s names and arguments).  Returns the
    global device count: the ranks of the group, one device each.

    Each argument not given comes from torchrun's environment
    (``WORLD_SIZE``, ``RANK``, ``MASTER_ADDR``/``MASTER_PORT``).  With one
    process and no coordinator nothing is joined, as in ``admm_tpu``, and
    the count is that of the visible devices (``mesh.visible_devices``).

    ``device`` is this rank's device: by default ``cuda:LOCAL_RANK``
    (``LOCAL_RANK`` from the environment, else ``process_id``);
    ``device="cpu"`` solves on the CPU.  ``backend`` defaults to ``"nccl"``
    on a CUDA device and ``"gloo"`` on the CPU.  Under NCCL a rank whose
    local rank has no card of its own raises ``ValueError`` (NCCL refuses
    two ranks on one card); ``backend="gloo"`` lets ranks share cards,
    rank r on card r modulo the card count.  ``timeout`` (seconds) bounds
    every collective's wait.
    """
    import torch.distributed as dist

    from .mesh import visible_devices

    if num_processes is None:
        num_processes = _env_int("WORLD_SIZE")
    if process_id is None:
        process_id = _env_int("RANK")
    if not (num_processes is not None and num_processes > 1 or coordinator_address):
        return visible_devices(resolve_device(device))
    if num_processes is None or process_id is None:
        raise ValueError("initialize_cluster needs num_processes and process_id (or "
                         "torchrun's WORLD_SIZE and RANK)")
    local = _env_int("LOCAL_RANK")
    local = int(process_id) if local is None else local
    dev = resolve_device(device)
    if backend is None:
        backend = "nccl" if dev.type == "cuda" else "gloo"
    if dev.type == "cuda":
        count = torch.cuda.device_count()
        if dev.index is None:
            if backend == "nccl" and local >= count:
                raise ValueError(
                    f"rank {process_id} (local rank {local}) would share a card: NCCL takes "
                    f"one card per rank and {count} are visible; pass backend=\"gloo\" to "
                    f"run several ranks on one card")
            dev = torch.device("cuda", local % count)
        torch.cuda.set_device(dev)
    if dist.is_initialized():
        raise RuntimeError("initialize_cluster: a default process group already exists")
    dist.init_process_group(
        backend=backend, init_method=_init_method(coordinator_address),
        world_size=int(num_processes), rank=int(process_id),
        timeout=datetime.timedelta(seconds=float(timeout)))
    _RANK_DEVICE["device"] = dev
    return dist.get_world_size()


def rank_device() -> torch.device:
    """This rank's device: the one ``initialize_cluster`` chose, else (a
    group made outside ``initialize_cluster``) the current CUDA device,
    raising when no card is visible as every default of the port does;
    a mesh over such a group solves on the CPU only with ``device="cpu"``."""
    if "device" in _RANK_DEVICE:
        return _RANK_DEVICE["device"]
    resolve_device(None)
    return torch.device("cuda", torch.cuda.current_device())


def shutdown() -> None:
    """Leave the cluster: destroy the default process group (if any) and
    forget this rank's device.  Drop the meshes over the group first
    (keep them in a function's frame that has returned): with a mesh still
    holding the group at interpreter exit, gloo's teardown aborted a rank
    now and then on a loaded CPU host ("terminate called without an
    active exception", after ``destroy_process_group`` had returned)."""
    import gc

    import torch.distributed as dist

    gc.collect()
    if dist.is_initialized():
        dist.destroy_process_group()
    _RANK_DEVICE.clear()


def global_mesh(axis_name: str = "shards", *, device=None):
    """A 1-D mesh over every rank of the cluster, one position per rank,
    on this rank's device (call after ``initialize_cluster``); without a
    process group, the stacked mesh over the visible devices of
    ``device`` (``mesh.make_mesh``)."""
    import torch.distributed as dist

    from .mesh import make_mesh

    if dist.is_available() and dist.is_initialized():
        return make_mesh(axis_name=axis_name, device=device, group=dist.group.WORLD)
    return make_mesh(axis_name=axis_name, device=device)


# What ``run_ranks`` prints once a rank has joined the group.
SENTINEL = "DIST_INIT_OK"

# The source each rank of ``run_ranks`` runs before its code: it joins the
# group (``JOIN``: ``initialize_cluster``'s keywords), prints the sentinel
# and defines ``rank``, ``ranks``, ``count`` (the global device count),
# ``mesh`` (``global_mesh()``) and ``save``.
_RANK_PREAMBLE = '''
import sys
import numpy as np
import torch
torch.set_num_threads(1)
from admm_tpu_torch.parallel import global_mesh, initialize_cluster, multihost
rank, ranks, _pg, _out = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4]
count = initialize_cluster("file://" + _pg, ranks, rank, **JOIN)
print("DIST_INIT_OK", flush=True)
mesh = global_mesh()


def save(**arrays):
    """This rank's arrays (tensors, numbers, lists) to <out>/r<rank>.npz."""
    np.savez(f"{_out}/r{rank}.npz", **{k: np.asarray(v.detach().cpu() if torch.is_tensor(v)
                                                     else v) for k, v in arrays.items()})
'''


def run_ranks(code: str, ranks: int, tmp, timeout: float = 120.0, *, join=None, path=()):
    """Run ``code`` in ``ranks`` new processes joined by one process group,
    each after ``initialize_cluster`` against a rendezvous file in ``tmp``
    (no port is taken).  ``join`` holds ``initialize_cluster``'s keywords
    (``backend``, ``device``, ``timeout``: give the collectives a timeout
    inside ``timeout``, so that ranks that stop apart fail instead of
    hanging); ``path`` lists directories put before this package's root on
    the ranks' ``PYTHONPATH``.

    ``code`` runs inside a function, with ``np``, ``torch``, ``rank``,
    ``ranks``, ``count``, ``mesh`` and ``save(**arrays)`` defined; its
    meshes are gone when the group is destroyed.  Every rank runs one
    thread.  The ranks are killed at ``timeout`` seconds.  Returns
    ``(rc, outputs, arrays)``: the first nonzero exit code (1 for a rank
    killed at the limit, 0 when every rank succeeded), each rank's
    output (stdout and stderr), and each rank's saved arrays (a dict, or
    None for a rank that saved nothing)."""
    tmp = Path(tmp)
    out = tmp / "out"
    out.mkdir(parents=True, exist_ok=True)
    src = (f"JOIN = {dict(join or {})!r}\n" + _RANK_PREAMBLE + "\n\ndef _work():\n"
           + textwrap.indent(textwrap.dedent(code), "    ")
           + "\n\n_work()\ndel mesh\nmultihost.shutdown()\n")
    env = dict(os.environ)
    root = str(Path(__file__).resolve().parents[2])
    env["PYTHONPATH"] = os.pathsep.join([*map(str, path), root, env.get("PYTHONPATH", "")])
    env["OMP_NUM_THREADS"] = "1"
    kids = [subprocess.Popen([sys.executable, "-c", src, str(r), str(ranks), str(tmp / "pg"),
                              str(out)], env=env, stdout=subprocess.PIPE,
                             stderr=subprocess.STDOUT, text=True) for r in range(ranks)]
    deadline = time.monotonic() + float(timeout)
    rc, outputs = 0, []
    for k in kids:
        try:
            text, _ = k.communicate(timeout=max(deadline - time.monotonic(), 0.1))
            rc = rc or k.returncode
        except subprocess.TimeoutExpired:
            for j in kids:
                j.kill()
            text, _ = k.communicate()
            text = (text or "") + f"\n(killed at the {timeout} s limit)\n"
            rc = rc or 1
        outputs.append(text or "")
    arrays = []
    for r in range(ranks):
        f = out / f"r{r}.npz"
        if f.exists():
            with np.load(f) as z:
                arrays.append({k: z[k] for k in z.files})
        else:
            arrays.append(None)
    return rc, outputs, arrays
