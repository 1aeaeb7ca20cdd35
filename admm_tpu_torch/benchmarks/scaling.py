"""Weak scaling of consensus-ADMM LASSO and a cost model for its
collectives (port of ``admm_tpu/benchmarks/scaling.py``).

Rows grow with the shard count (``rows_per_shard`` rows a shard, so the
work per shard is constant) and efficiency(W) = iters_per_sec(W) /
iters_per_sec(1).  On one device the W shards are stacked
(``parallel.make_mesh``), so every extra shard adds its work to the same
card: the sweep then checks the sharded program, not scaling.  Over a
process group (``mesh=parallel.global_mesh()``) the shards lie over the
ranks and the same sweep measures scaling.

The pieces of the cost model:

  * ``collective_microbench`` times ``Mesh.psum`` at the payloads a step
    sends (``consensus_payloads``, counted by ``Mesh.stats``): over a
    process group the real all-reduce (NCCL, or gloo), on a stacked mesh
    the zero-communication floor (the stacked mean).
  * ``host_collective_us``: that microbench over a process group (the
    current one, or a one-rank group made for it: NCCL on the card, gloo
    on the CPU), the host time each collective of a step costs before
    any byte moves.  On the card it dominates a step over ranks (a
    one-rank NCCL all_reduce costs hundreds of us of host where the
    stacked step takes under a millisecond, ``chip_smoke.py`` (z18a)).
  * ``predict_weak_scaling`` is a ring all-reduce model (latency plus
    bandwidth for each round) over two interconnect tiers, plus that
    measured host time for each collective, fed with the measured
    per-iteration compute time of one shard; each row also gives the
    efficiency without the host term (``efficiency_wire_only``).
  * ``breakeven_table``: the per-lane compute a step needs for 80%
    efficiency when B lanes share each round.

The tiers are NOT measurements.  Their bandwidths are public
specifications of the parts (NVIDIA's H100 SXM5 datasheet: NVLink 4 at
900 GB/s per GPU both ways, 450 GB/s each way; a ConnectX-7 NDR
InfiniBand port at 400 Gb/s, 50 GB/s each way); their per-hop latencies
are assumptions of this model (no public specification gives one).

Usage:  python -m admm_tpu_torch.benchmarks.scaling [--devices 8] [--rows-per-shard 4096]
            [--cols 512] [--iters 300] [--predict] [--device cpu]
"""

from __future__ import annotations

import json
import time

# Interconnect tiers: bandwidth from the public specifications above
# (GB/s each way), per-hop latency an assumption of the model (us).
_TIERS = {
    "nvlink4": {"lat_us": 1.0, "GBps": 450.0,
                "source": "H100 SXM5 datasheet: NVLink 4, 900 GB/s per GPU both ways; "
                          "latency assumed"},
    "nic_ndr400": {"lat_us": 10.0, "GBps": 50.0,
                   "source": "ConnectX-7 NDR InfiniBand, 400 Gb/s per port; latency assumed"},
}


def consensus_payloads(n: int):
    """The floats of each collective of one consensus LASSO step, as
    ``Mesh.stats`` counts them: xbar and ubar together (2n), then the
    residual's sum (1)."""
    return (2 * n, 1)


def weak_scaling(device_counts=(1, 2, 4, 8), rows_per_shard=4096, cols=512, iters=300,
                 quiet=False, *, device=None, mesh=None):
    """Iterations per second of ``consensus_lasso`` (float32, ``iters``
    steps, ``domaxiters``) at each shard count W, ``rows_per_shard * W``
    rows; returns ``({W: iter/s}, {W: efficiency})``.  Each W is solved
    twice and the second run timed.  ``mesh``: a process group's mesh
    (every rank calls this with the same arguments; each W a multiple of
    its ranks), else W shards stacked on ``device``."""
    import numpy as np
    import torch

    from admm_tpu_torch import ADMMConfig
    from admm_tpu_torch.parallel import consensus_lasso, make_mesh

    cfg = ADMMConfig(maxiters=iters, domaxiters=True)
    results = {}
    for W in device_counts:
        rng = np.random.default_rng(0)
        m = rows_per_shard * W
        on = make_mesh(W, device=device) if mesh is None else mesh
        D = torch.as_tensor(rng.standard_normal((m, cols)).astype(np.float32), device=on.device)
        s = torch.as_tensor(rng.standard_normal(m).astype(np.float32), device=on.device)
        consensus_lasso(D, s, 0.1, cfg, mesh=on, nshards=W)
        res = consensus_lasso(D, s, 0.1, cfg, mesh=on, nshards=W)
        ips = iters / res.runtime
        results[W] = ips
        if not quiet:
            print(json.dumps({"metric": "consensus_lasso_weak_scaling", "devices": W,
                              "ranks": on.world, "rows": m, "cols": cols, "value": ips,
                              "unit": "iter/s", "device": str(on.device)}))
    base = results[min(results)]
    effs = {W: results[W] / base for W in results}
    if not quiet:
        line = {"metric": "weak_scaling_efficiency",
                "efficiency": {str(W): e for W, e in effs.items()}, "target": 0.8}
        if mesh is None:
            line["caveat"] = ("W shards stacked on one device share it: this checks the "
                              "sharded program, it does not measure scaling")
        print(json.dumps(line))
    return results, effs


def collective_microbench(payload_floats=None, inner=256, quiet=False, *, mesh=None,
                          device=None, cols=512):
    """Time one collective of a consensus step: ``inner`` chained
    ``Mesh.psum`` rounds of each payload (default
    ``consensus_payloads(cols)``), float32, best of three.  Over ``mesh``'s
    process group that is the all-reduce; on a stacked mesh (default, 8
    shards on ``device``) the stacked mean over dim 0, the zero-comm
    floor.  Returns one row per payload."""
    import torch

    from admm_tpu_torch.parallel import make_mesh

    mesh = make_mesh(8, device=device) if mesh is None else mesh
    dev = mesh.device
    payloads = consensus_payloads(cols) if payload_floats is None else payload_floats
    backend = "stacked"
    if mesh.group is not None:
        import torch.distributed as dist

        backend = dist.get_backend(mesh.group)
    rows = []
    for n in payloads:
        x = torch.randn((8, int(n)), generator=torch.Generator().manual_seed(0)).to(dev)

        def run(x=x):
            c = x
            for _ in range(inner):
                if mesh.group is None:
                    c = c - 0.5 * torch.mean(c, dim=0, keepdim=True)
                else:
                    c = c - 0.5 * mesh.psum(c[0])[None, :]
            return c

        run()
        best = float("inf")
        for _ in range(3):
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
            t0 = time.perf_counter()
            run()
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
            best = min(best, time.perf_counter() - t0)
        row = {"metric": "collective_roundtrip", "backend": backend, "ranks": mesh.world,
               "payload_floats": int(n), "us_per_collective": best / inner * 1e6,
               "device": str(dev)}
        if mesh.group is None:
            row["note"] = "stacked mesh: the zero-comm floor (the stacked mean)"
        rows.append(row)
        if not quiet:
            print(json.dumps(row))
    return rows


def host_collective_us(cols=512, inner=256, quiet=False, *, device=None):
    """The host time of one collective of a consensus step (us): the mean
    of ``collective_microbench``'s rows at ``consensus_payloads(cols)``
    over the current process group, or over a one-rank group made here
    and left afterwards (NCCL on the card, gloo with ``device="cpu"``).
    One rank moves no bytes, so this is the cost of issuing the
    collective alone.  Returns ``(us, rows)``."""
    import tempfile

    import torch.distributed as dist

    from admm_tpu_torch.parallel import global_mesh, multihost

    if dist.is_available() and dist.is_initialized():
        rows = collective_microbench(inner=inner, quiet=quiet, cols=cols,
                                     mesh=global_mesh(device=device))
    else:
        with tempfile.TemporaryDirectory() as tmp:
            multihost.initialize_cluster(f"file://{tmp}/pg", 1, 0, device=device, timeout=120)
            try:
                # The mesh dies with the call, before the group is left.
                rows = collective_microbench(inner=inner, quiet=quiet, cols=cols,
                                             mesh=global_mesh())
            finally:
                multihost.shutdown()
    return sum(r["us_per_collective"] for r in rows) / len(rows), rows


def _ring_allreduce_us(payload_bytes, W, tier):
    """A ring all-reduce: 2(W-1)/W payload passes over the link bandwidth
    plus 2(W-1) hop latencies."""
    t = _TIERS[tier]
    bw_us = 2.0 * (W - 1) / W * payload_bytes / (t["GBps"] * 1e3)  # bytes / (GB/s) -> us
    return bw_us + 2.0 * (W - 1) * t["lat_us"]


def predict_weak_scaling(t_compute_us, n, payloads=None,
                         scenarios=(("nvlink4", 8), ("nic_ndr400", 2)), quiet=False, *,
                         host_us=0.0):
    """Predicted weak-scaling efficiency t / (t + t_collectives) from the
    measured per-iteration compute time of one shard, with each round of
    ``payloads`` (float32 counts; default ``consensus_payloads(n)``) one
    ring all-reduce on the tier plus ``host_us``, the measured host time
    of issuing one collective (``host_collective_us``)."""
    payloads = consensus_payloads(n) if payloads is None else payloads
    out = []
    for tier, W in scenarios:
        wire = sum(_ring_allreduce_us(4.0 * p, W, tier) for p in payloads)
        coll = wire + host_us * len(payloads)
        eff = t_compute_us / (t_compute_us + coll)
        row = {"metric": "predicted_weak_scaling_efficiency", "tier": tier, "devices": W,
               "payload_floats_per_step": list(payloads), "t_compute_us": t_compute_us,
               "t_wire_us": wire, "host_us_per_collective": host_us,
               "t_collective_us": coll, "efficiency": eff,
               "efficiency_wire_only": t_compute_us / (t_compute_us + wire), "target": 0.8,
               "meets_target": bool(eff >= 0.8), "tier_source": _TIERS[tier]["source"]}
        out.append(row)
        if not quiet:
            print(json.dumps(row))
    return out


def breakeven_table(n=512, lanes=(1, 8, 64), quiet=False, *, host_us=0.0):
    """Per tier and lane count B: the per-lane compute time per iteration
    at which the 80% target holds when B consensus lanes share each
    round (payload ``consensus_payloads(n)`` times B, each collective
    ``host_us`` of host besides), i.e. t_compute >= 4 t_collective / B."""
    out = []
    for tier, W in (("nvlink4", 8), ("nic_ndr400", 2)):
        for B in lanes:
            coll = sum(_ring_allreduce_us(4.0 * p * B, W, tier) + host_us
                       for p in consensus_payloads(n))
            row = {"metric": "weak_scaling_breakeven", "tier": tier, "devices": W, "lanes": B,
                   "payload_floats_per_step": [p * B for p in consensus_payloads(n)],
                   "host_us_per_collective": host_us,
                   "t_collective_us": coll, "min_per_lane_compute_us_for_80pct": 4.0 * coll / B}
            out.append(row)
            if not quiet:
                print(json.dumps(row))
    return out


def measured_t_compute(rows_per_shard=4096, cols=512, iters=300, *, device=None):
    """The per-iteration time (us) of a one-shard consensus LASSO, timed
    on the solve's wall clock (second of two runs)."""
    import numpy as np
    import torch

    from admm_tpu_torch import ADMMConfig
    from admm_tpu_torch.device import resolve_device
    from admm_tpu_torch.parallel import consensus_lasso, make_mesh

    dev = resolve_device(device)
    rng = np.random.default_rng(0)
    D = torch.as_tensor(rng.standard_normal((rows_per_shard, cols)).astype(np.float32),
                        device=dev)
    s = torch.as_tensor(rng.standard_normal(rows_per_shard).astype(np.float32), device=dev)
    cfg = ADMMConfig(maxiters=iters, domaxiters=True)
    mesh = make_mesh(1, device=dev)
    consensus_lasso(D, s, 0.1, cfg, mesh=mesh, nshards=1)
    return consensus_lasso(D, s, 0.1, cfg, mesh=mesh, nshards=1).runtime / iters * 1e6


def main(devices=8, rows_per_shard=4096, cols=512, iters=300, predict=False,
         t_compute_us=None, device=None) -> int:
    """The CLI's ``scaling``: the weak-scaling sweep over 1, 2, 4, ... up
    to ``devices`` stacked shards, or with ``predict`` the microbench
    over a process group (``host_collective_us``), the prediction and the
    break-even table, both with the measured host time of a collective."""
    if predict:
        host_us, _ = host_collective_us(cols, device=device)
        t_us = t_compute_us
        if t_us is None:
            t_us = measured_t_compute(rows_per_shard, cols, iters, device=device)
            print(json.dumps({"metric": "measured_t_compute", "us_per_iter": t_us,
                              "shape": f"{rows_per_shard}x{cols}"}))
        predict_weak_scaling(t_us, cols, host_us=host_us)
        breakeven_table(cols, host_us=host_us)
        return 0
    counts = [w for w in (1, 2, 4, 8) if w <= devices]
    weak_scaling(device_counts=counts, rows_per_shard=rows_per_shard, cols=cols, iters=iters,
                 device=device)
    return 0


if __name__ == "__main__":
    import argparse

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--devices", type=int, default=8)
    ap.add_argument("--rows-per-shard", type=int, default=4096)
    ap.add_argument("--cols", type=int, default=512)
    ap.add_argument("--iters", type=int, default=300)
    ap.add_argument("--predict", action="store_true")
    ap.add_argument("--t-compute-us", type=float, default=None)
    ap.add_argument("--device", default=None)
    a = ap.parse_args()
    raise SystemExit(main(a.devices, a.rows_per_shard, a.cols, a.iters, a.predict,
                          a.t_compute_us, a.device))
