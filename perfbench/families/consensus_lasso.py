"""The dense lasso split across examples (Boyd et al. 2011, section 8.2.1)
at the size of its section 11 run, over several ranks of one process
group, each holding only its own rows.

Data: ``lasso_example.m``'s generator over all m rows: D (m x n) with
N(0, 1) entries and unit columns, a planted x0 with a share ``density``
of N(0, 1) entries, s = D x0 + sqrt(noise_var) N(0, 1).  The rows fall
into W = ``shards`` shards of m/W rows, W/P on each of the P = ``ranks``
ranks in rank order.  Each rank draws only its own shards, each from
``base_seed`` and the shard's index, and x0 from ``base_seed`` alone; the
column norms and lambda_max = ||D^T s||_inf come from one all-reduce each.
The run's seed permutes the columns and flips their signs on every rank
alike: the same problems, other inputs.

Ranks: rank 0 is the harness's process.  ``make_pool`` starts the other
P - 1 as helper processes (this file run as a script), one on each card,
and joins them in one process group (NCCL on the card, gloo on the CPU)
through ``admm_tpu_torch.parallel.initialize_cluster``.  Each rank is
bound to whole cores of its own (``core_sets``), as an MPI launcher binds
its ranks: the chunk loop is host-bound, and every collective waits for
the slowest rank's host.  Rank 0 then
drives every step of theirs by broadcasting a command (``_Ranks.send``):
a pool to draw, a request to solve, a reference to run, or stop.  So all
ranks issue their collectives in one order.  A helper exits when told to
stop, or within ``WATCH_S`` of rank 0's exit, and refuses to run if it
loaded ``jax`` or ``admm_tpu``; rank 0 ends the run at once if a helper
exits unasked, and a request that raises ends the run, since the ranks
can no longer match their collectives.

Traffic ``kind`` ``lambda_grid``: a request is one cold-started
``admm_tpu_torch.parallel.consensus_lasso`` call on every rank, with the
rank's own rows, at one lambda of the grid lambda_max
``lambda_min_ratio``^(``every`` k / (``nlambda`` - 1)), k = 0 ..
``count`` - 1; rounds of ``count`` requests use each lambda once.  After
each call every rank's x, z, u and steps are hashed and the hashes
compared; a mismatch fails the request.
"""

from __future__ import annotations

import atexit
import dataclasses
import json
import math
import os
import shutil
import subprocess
import sys
import tempfile
import threading
import time
from pathlib import Path

import torch

from benchlib import roofline
from benchlib.runner import forbidden_modules
from families.common import Outcome, Spec, admm_config, rounds
from reference.consensus_lasso import admm_consensus_lasso

# Rank 0's commands: the first word of each broadcast.
POOL, SOLVE, REFERENCE, PEAKS, STOP = 1, 2, 3, 4, 5
WORDS = 6
# The precisions a REFERENCE runs in, by their index in the command.
REF_PRECISIONS = ("float64", "bfloat16")
# A helper's log line that gives rank 0 the times of its start-up.
TIMING = "# timing "
# How long a collective waits for the other ranks before it fails, and how
# often a helper looks for rank 0.
GROUP_TIMEOUT_S = 300.0
WATCH_S = 1.0


@dataclasses.dataclass
class RankSpec(Spec):
    """A request, with the collectives its call issued on rank 0
    (``Mesh.stats`` calls by operation), set by the call."""

    collectives: dict = None


@dataclasses.dataclass
class Pool:
    """This rank's share of the problem: its shards ``D`` (W/P, m/W, n)
    and ``s`` (W/P, m/W), the lambda grid, the mesh over the group, and
    the port's ``ADMMConfig``; the steps of each lambda's first request."""

    D: torch.Tensor
    s: torch.Tensor
    lams: list
    mesh: object
    shards: int
    device: torch.device
    cfg: object
    peaks: list = None
    steps: dict = dataclasses.field(default_factory=dict)


def _draw(config, traffic, seed, device, group):
    """This rank's shards of the problem, permuted by ``seed``, and the
    lambda grid (one all-reduce for the column norms, one for D^T s)."""
    import torch.distributed as dist

    W, m, n = config["shards"], config["m"], config["n"]
    P, rank = dist.get_world_size(group), dist.get_rank(group)
    if W % P or m % W:
        raise ValueError(f"{m} rows in {W} shards over {P} ranks do not divide evenly")
    per, mi = W // P, m // W
    dt = getattr(torch, config["dtype"])
    g = torch.Generator(device=device)
    g.manual_seed(config["base_seed"])
    x0 = torch.randn(n, generator=g, device=device, dtype=dt)
    x0 *= torch.rand(n, generator=g, device=device, dtype=dt) < config["density"]
    D = torch.empty((per, mi, n), device=device, dtype=dt)
    noise = torch.empty((per, mi), device=device, dtype=dt)
    colsq = torch.zeros(n, device=device, dtype=dt)
    for j in range(per):
        g.manual_seed(config["base_seed"] * 1_000_003 + rank * per + j + 1)
        torch.randn((mi, n), generator=g, out=D[j])
        torch.randn((mi,), generator=g, out=noise[j])
        colsq += torch.sum(D[j] * D[j], dim=0)
    dist.all_reduce(colsq, group=group)
    D /= torch.sqrt(colsq)
    s = torch.bmm(D, x0.expand(per, n)[..., None])[..., 0] + math.sqrt(config["noise_var"]) * noise
    del noise, x0
    cpu = torch.Generator()
    cpu.manual_seed(seed)
    cols = torch.randperm(n, generator=cpu).to(device)
    signs = (torch.randint(0, 2, (n,), generator=cpu) * 2 - 1).to(device=device, dtype=dt)
    for j in range(per):
        D[j] = D[j][:, cols] * signs
    Dts = torch.einsum("wij,wi->j", D, s)
    dist.all_reduce(Dts, group=group)
    lam_max = float(Dts.abs().max())
    lams = [lam_max * traffic["lambda_min_ratio"] ** (traffic["every"] * k / (traffic["nlambda"] - 1))
            for k in range(traffic["count"])]
    return D, s, lams


def _digest(ts) -> torch.Tensor:
    """A hash of the tensors' bytes, as one int64 on their device."""
    b = torch.cat([t.contiguous().reshape(-1).view(torch.uint8) for t in ts]).to(torch.int64)
    w = (torch.arange(b.numel(), device=b.device, dtype=torch.int64) * 2654435761) % 2**31 + 1
    return torch.sum(b * w).reshape(1)


def _gather(pool, t):
    """Every rank's ``t`` (one all-gather)."""
    import torch.distributed as dist

    every = [torch.empty_like(t) for _ in range(pool.mesh.world)]
    dist.all_gather(every, t, group=pool.mesh.group)
    return every


def _solve(pool, entry):
    """The port's call on this rank at lambda ``entry``; every rank's x,
    z, u and steps compared by hash."""
    from admm_tpu_torch.parallel import consensus_lasso

    res = consensus_lasso(pool.D, pool.s, pool.lams[entry], pool.cfg, mesh=pool.mesh,
                          nshards=pool.shards)
    steps = torch.tensor([res.steps], device=pool.device, dtype=torch.int64)
    h = _digest([res.xopt, res.zopt, res.uopt, steps])
    same = all(bool(torch.equal(e, h)) for e in _gather(pool, h))
    return Outcome(res.xopt[None], res.zopt[None], res.uopt[None], [res.steps], res.runtime,
                   bool(res.diverged) or not same)


def _reference(config, pool, entry, stop_at, precision):
    return admm_consensus_lasso(
        pool.D, pool.s, pool.lams[entry], pool.shards, rho=config["rho"],
        abstol=config["abstol"], reltol=config["reltol"], maxiters=config["maxiters"],
        stop_at=None if stop_at < 0 else [stop_at], precision=precision,
        group=pool.mesh.group)


def core_sets(ranks: int, cpus=None, root: str = "/sys/devices/system/cpu"):
    """``cpus`` (by default the CPUs this process may run on) as ``ranks``
    sets of whole physical cores, in (package, core) order, or None where
    there are fewer cores than ranks."""
    cpus = sorted(os.sched_getaffinity(0) if cpus is None else cpus)
    cores = {}
    for c in cpus:
        try:
            key = tuple(int(Path(root, f"cpu{c}", "topology", name).read_text())
                        for name in ("physical_package_id", "core_id"))
        except (OSError, ValueError):
            key = (0, c)
        cores.setdefault(key, []).append(c)
    whole = [cores[k] for k in sorted(cores)]
    if len(whole) < ranks:
        return None
    per = len(whole) // ranks
    return [sorted(c for core in whole[r * per:(r + 1) * per] for c in core)
            for r in range(ranks)]


class _Ranks:
    """Rank 0's side of the process group: the helpers, the group, and the
    commands.  One a process: a process joins one default group."""

    def __init__(self, ranks: int, device: torch.device):
        from admm_tpu_torch.parallel import global_mesh, initialize_cluster

        self.device, self.broken, self.stopping = device, False, False
        self.cores = core_sets(ranks)
        if self.cores:
            os.sched_setaffinity(0, self.cores[0])
        self.tmp = tempfile.mkdtemp(prefix="perfbench_ranks_")
        here = Path(__file__).resolve()
        env = dict(os.environ, PYTHONPATH=os.pathsep.join(
            [str(here.parents[1]), str(here.parents[2]), os.environ.get("PYTHONPATH", "")]))
        self.logs = [Path(self.tmp) / f"rank{r}.log" for r in range(1, ranks)]
        self.helpers, self.started = [], time.time()
        for r, log in zip(range(1, ranks), self.logs):
            with open(log, "w") as f:
                self.helpers.append(subprocess.Popen(
                    [sys.executable, str(here), str(r), str(ranks), self.tmp, device.type],
                    env=env, stdin=subprocess.DEVNULL, stdout=f, stderr=subprocess.STDOUT))
            if self.cores:
                # Before the helper's interpreter starts a thread: its
                # threads inherit the binding.
                os.sched_setaffinity(self.helpers[-1].pid, self.cores[r])
        self.spawned = time.time()
        atexit.register(self.close)
        threading.Thread(target=self._watch, daemon=True).start()
        initialize_cluster("file://" + str(Path(self.tmp) / "rendezvous"), ranks, 0,
                           device=device, timeout=GROUP_TIMEOUT_S)
        self.mesh = global_mesh()
        self.joined = time.time()

    def timings(self, sent: float, drawn: float) -> str:
        """The ranks' start-up in phases, in seconds from the helpers'
        spawning: the helpers' own (their ``TIMING`` lines), the group's
        join, the first collective (NCCL's communicators made), the draw."""
        seen = []
        for log in self.logs:
            for line in log.read_text(errors="replace").splitlines():
                if line.startswith(TIMING):
                    seen.append(json.loads(line[len(TIMING):]))

        def span(key):
            got = [t[key] - self.started for t in seen]
            return f"{min(got):.3f}-{max(got):.3f}" if got else "?"

        return (f"ranks' start-up (s after rank 0 spawned the helpers, which took "
                f"{self.spawned - self.started:.3f}): helpers' imports (python, torch, the "
                f"benchmark's modules) done at {span('imported')}, the port's at "
                f"{span('port')}, CUDA and the group joined at {span('joined')}; rank 0 joined "
                f"at {self.joined - self.started:.3f}; the first command (NCCL's "
                f"communicators) sent at {sent - self.started:.3f}; its shards drawn at "
                f"{drawn - self.started:.3f}")

    def _watch(self):
        """End the run at once if a helper exits unasked: rank 0 would wait
        in its next collective for the group's timeout."""
        while not self.stopping:
            for h, log in zip(self.helpers, self.logs):
                if h.poll() is not None and not self.stopping:
                    self._fail(f"helper {log.stem} exited with {h.returncode}")
            time.sleep(WATCH_S)

    def _fail(self, why):
        sys.stdout.flush()
        print(f"perfbench: {why} (helpers' exit codes "
              f"{[h.poll() for h in self.helpers]}); their logs end:", file=sys.stderr)
        for log in self.logs:
            text = log.read_text(errors="replace") if log.exists() else ""
            print(f"--- {log.stem} ---\n{text[-3000:]}", file=sys.stderr)
        sys.stderr.flush()
        for h in self.helpers:
            h.kill()
        shutil.rmtree(self.tmp, ignore_errors=True)
        os._exit(1)

    def send(self, *words, payload: bytes = b""):
        """Broadcast a command from rank 0, and ``payload`` after it."""
        import torch.distributed as dist

        cmd = torch.zeros(WORDS, dtype=torch.int64)
        cmd[:len(words)] = torch.tensor(words, dtype=torch.int64)
        cmd[WORDS - 1] = len(payload)
        dist.broadcast(cmd.to(self.device), 0)
        if payload:
            dist.broadcast(torch.frombuffer(bytearray(payload), dtype=torch.uint8).to(self.device),
                           0)

    def run(self, fn, *args):
        """``fn(*args)`` on rank 0 in step with the helpers; if it raises, the
        ranks can no longer match their collectives, so the run ends."""
        try:
            return fn(*args)
        except BaseException as exc:
            self.broken = True
            raise SystemExit(f"perfbench: rank 0 raised {type(exc).__name__}: {exc}") from exc

    def _leave(self):
        from admm_tpu_torch.parallel import multihost

        self.send(STOP)
        self.mesh = None
        multihost.shutdown()

    def close(self):
        """Tell the helpers to stop and leave the group with them (NCCL's
        teardown waits for every rank); with the group broken, kill them
        and leave at once."""
        if self.stopping:
            return
        self.stopping = True
        if not self.broken:
            leaving = threading.Thread(target=self._leave, daemon=True)
            leaving.start()
            leaving.join(60.0)
            self.broken = leaving.is_alive()
        for h in self.helpers:
            try:
                h.wait(timeout=0.1 if self.broken else 30.0)
            except subprocess.TimeoutExpired:
                h.kill()
                self.broken = True
        if self.broken or any(h.returncode for h in self.helpers):
            self._fail("the ranks did not stop together")
        shutil.rmtree(self.tmp, ignore_errors=True)


_RANKS = None


def _ranks(config, device) -> _Ranks:
    global _RANKS
    if _RANKS is None:
        _RANKS = _Ranks(int(config["ranks"]), device)
    return _RANKS


def _pool(config, traffic, seed, device, mesh):
    D, s, lams = _draw(config, traffic, seed, device, mesh.group)
    return Pool(D, s, lams, mesh, config["shards"], device, admm_config(config))


def make_pool(config, traffic, seed, device):
    fresh = _RANKS is None
    R = _ranks(config, device)
    R.send(POOL, seed, payload=json.dumps([config, traffic]).encode())
    sent = time.time()
    pool = R.run(_pool, config, traffic, seed, device, R.mesh)
    if fresh:
        # _draw's last line reads the device, so the draw is done.
        print(f"# {R.timings(sent, time.time())}", flush=True)
    return pool


def requests(config, traffic, seed, pool):
    """The seed's endless request stream: rounds over the lambda grid."""
    for i, entry in enumerate(rounds(seed, traffic["count"])):
        yield RankSpec(i, entry, pool.lams[entry])


def port(config, traffic):
    """The port's entry on every rank: ``call(pool, spec) -> Outcome``."""

    def call(pool, spec):
        before = dict(pool.mesh.stats["calls"])
        _RANKS.send(SOLVE, spec.entry)
        out = _RANKS.run(_solve, pool, spec.entry)
        after = pool.mesh.stats["calls"]
        spec.collectives = {k: after[k] - before.get(k, 0) for k in after}
        pool.steps.setdefault(spec.entry, out.steps[0])
        return out

    return call


def reference(config, pool, spec, stop_at=None, precision="float64"):
    """The plain reference on every rank's own shards, its sums over the
    group: (x, z, u, own steps) of the whole problem.  Before the first
    one on a pool, every rank's memory peak so far is gathered and
    printed, and the port's steps by lambda."""
    if pool.peaks is None:
        _RANKS.send(PEAKS)
        pool.peaks = _RANKS.run(memory_peaks, pool)
        print(f"# memory peak by rank (bytes): {pool.peaks}; the fullest "
              f"{max(pool.peaks)} on rank {pool.peaks.index(max(pool.peaks))}", flush=True)
        if pool.steps:
            print("# steps by lambda index: " + ", ".join(
                f"{k} {pool.steps[k]}" for k in sorted(pool.steps)), flush=True)
    at = -1 if stop_at is None else int(stop_at[0])
    _RANKS.send(REFERENCE, spec.entry, at, REF_PRECISIONS.index(precision))
    return _RANKS.run(_reference, config, pool, spec.entry, at, precision)


def controls(config, traffic):
    """The control, in the port's place: the reference computed in
    bfloat16, the next precision below the configuration's float32.  (A
    TF32 reading cannot be one at these widths: it lies within the port's
    own float32 range, as the limits file notes.)"""

    def reference_bf16(pool, spec):
        x, z, u, steps = reference(config, pool, spec, precision="bfloat16")
        return Outcome(x, z, u, steps, 0.0)

    return {"reference_bf16": reference_bf16}


def local_solve(config) -> roofline.Cost:
    """One step's local solves on one rank, at their least inputs: per
    shard the smaller of the n x n inverse and (D_i, a triangular
    m_i x m_i factor), min(n^2, m_i n + m_i (m_i + 1) / 2) words, each read
    once, the right-hand side read and x_i written; operations of that
    form (2 n^2, or 4 m_i n + 2 m_i^2)."""
    W, P, m, n = config["shards"], config["ranks"], config["m"], config["n"]
    mi, per = m // W, W // P
    wood = mi * n + mi * (mi + 1) // 2
    words, flops = (n * n, 2.0 * n * n) if n * n <= wood else \
        (wood, 4.0 * mi * n + 2.0 * mi * mi)
    return roofline.Cost(bytes=per * (words + 2 * n) * 4, flops=per * flops)


def layer_cost(layer, config, lanes):
    """The least-time work of ``layer`` for one step (one lane; None for
    a layer this family does not have)."""
    return local_solve(config) if layer == "local_solve" else None


def working_set(config):
    """What a rank holds, against the card."""
    W, P, m, n = config["shards"], config["ranks"], config["m"], config["n"]
    per, mi = W // P, m // W
    least = local_solve(config)
    return (f"working set: each of {P} ranks holds {per} shards of {mi} x {n} rows "
            f"({4 * per * mi * n / 1e9:.2f} GB) and builds their n x n inverses "
            f"({4 * per * n * n / 1e9:.2f} GB) each request; a step streams the inverses, and "
            f"the local solves' least inputs are {least.bytes / 1e9:.3f} GB a rank "
            f"({1e3 * least.seconds:.3f} ms at {roofline.HBM_BYTES_PER_S / 1e12:.2f} TB/s)")


def counters():
    """``Mesh.stats``' collective calls of rank 0, keyed by a part of the
    NCCL kernel's name that each becomes."""
    calls = _RANKS.mesh.stats["calls"] if _RANKS is not None and _RANKS.mesh else {}
    return {"AllReduce": calls.get("all_reduce", 0), "AllGather": calls.get("all_gather", 0)}


def memory_peaks(pool):
    """Every rank's device memory peak (one all-gather; zeros on the CPU)."""
    peak = torch.cuda.max_memory_allocated(pool.device) if pool.device.type == "cuda" else 0
    return [int(e) for e in _gather(pool, torch.tensor([peak], device=pool.device))]


# ---- a helper rank ---------------------------------------------------------


def _helper(rank: int, ranks: int, tmp: str, kind: str):
    """Rank ``rank``: join the group, then run rank 0's commands until
    told to stop."""
    import torch.distributed as dist

    imported = time.time()
    from admm_tpu_torch.parallel import global_mesh, initialize_cluster, multihost

    port = time.time()
    parent = os.getppid()

    def watch():
        while True:
            if os.getppid() != parent:
                os._exit(2)
            time.sleep(WATCH_S)

    threading.Thread(target=watch, daemon=True).start()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = torch.device("cuda", rank) if kind == "cuda" else torch.device("cpu")
    initialize_cluster("file://" + str(Path(tmp) / "rendezvous"), ranks, rank, device=device,
                       timeout=GROUP_TIMEOUT_S)
    mesh = global_mesh()
    print(TIMING + json.dumps({"imported": imported, "port": port, "joined": time.time()}),
          flush=True)
    pool = config = None
    while True:
        cmd = torch.empty(WORDS, dtype=torch.int64, device=device)
        dist.broadcast(cmd, 0)
        op, a, b, c, _, size = cmd.tolist()
        payload = b""
        if size:
            buf = torch.empty(size, dtype=torch.uint8, device=device)
            dist.broadcast(buf, 0)
            payload = bytes(buf.cpu().tolist())
        if op == POOL:
            config, traffic = json.loads(payload)
            pool = None
            pool = _pool(config, traffic, a, device, mesh)
        elif op == SOLVE:
            _solve(pool, a)
        elif op == REFERENCE:
            _reference(config, pool, a, b, REF_PRECISIONS[c])
        elif op == PEAKS:
            memory_peaks(pool)
        elif op == STOP:
            break
        else:
            raise ValueError(f"rank {rank}: unknown command {op}")
        bad = forbidden_modules()
        if bad:
            print(f"rank {rank} loaded {bad}; the benchmark measures admm_tpu_torch alone",
                  flush=True)
            os._exit(3)
    print(f"rank {rank}: told to stop", flush=True)
    del pool, mesh
    multihost.shutdown()
    print(f"rank {rank}: left the group", flush=True)


if __name__ == "__main__":
    _helper(int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4])
