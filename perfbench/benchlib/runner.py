"""One run of one cell: set-up, the measured window, the comparison with
the reference, and the result line.

Set-up (``setup_s``) runs from the start of the process to the end of
one warm request of the cell's own shapes: imports, CUDA initialisation,
the port's kernel library (built under ``build/kernels/`` of the
checkout on the first run there, loaded after), the instance pool made
on the card from the seed, and the warm request.  The window follows
(``benchlib.window``); with ``--trace 1`` a steady part of it runs under
the profiler.  Once the window has closed the memory peak is read, the
port's results that are not checked are dropped, and the checked ones
are held against the plain reference.
"""

from __future__ import annotations

import json
import os
import random
import sys
import time
from pathlib import Path

from benchlib import compare, device as devinfo, spec, trace as tracing, window
from benchlib.context import RunData

FORBIDDEN = ("jax", "jaxlib", "flax", "admm_tpu")


def forbidden_modules() -> list:
    """Modules whose top-level name (before the first dot), compared
    whole, is ``jax``, ``jaxlib``, ``flax`` or ``admm_tpu``."""
    return sorted(m for m in list(sys.modules) if m.split(".")[0] in FORBIDDEN)


def configure_caches(root: Path):
    """Point the caches a build could use at fixed directories inside the
    checkout (the port builds its kernels under ``build/kernels/``)."""
    os.environ.setdefault("TORCH_EXTENSIONS_DIR", str(root / "build" / "torch_extensions"))
    os.environ.setdefault("TRITON_CACHE_DIR", str(root / "build" / "triton"))


def _sync(dev):
    import torch

    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def checked_indices(seed: int, reqs: list, k: int) -> list:
    """The requests held against the reference: the one whose loop ran
    longest, and a sample of the rest drawn from the seed."""
    if not reqs:
        return []
    longest = max(range(len(reqs)), key=lambda i: (max(reqs[i].steps), reqs[i].wall))
    rest = [i for i in range(len(reqs)) if i != longest]
    rng = random.Random(seed ^ 0x5EED5EED)
    return sorted([longest] + rng.sample(rest, min(k - 1, len(rest))))


def run_cell(cell, seed: int, seconds: float, trace: bool, dev, t_start: float,
             system=None, log=print) -> dict:
    """Run ``cell``; return the result line's fields (without printing).

    ``system(pool, spec) -> Outcome`` replaces the port's entry (the
    controls and the tests use it)."""
    import torch

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    fam, cfg, trf = cell.family, cell.config, cell.traffic
    pool = fam.make_pool(cfg, trf, seed, dev)
    _sync(dev)
    t_pool = time.perf_counter() - t_start
    call = system or fam.port(cfg, trf)
    stream = fam.requests(cfg, trf, seed, pool)

    def issue(i, traced):
        sp = next(stream)
        ctx = torch.profiler.record_function(tracing.REQUEST_SPAN) if traced else None
        failed = False
        t0 = time.perf_counter()
        if ctx is not None:
            ctx.__enter__()
        try:
            out = call(pool, sp)
            _sync(dev)
        except RuntimeError as exc:
            log(f"# request {i} failed: {type(exc).__name__}: {str(exc)[:300]}")
            out, failed = None, True
        finally:
            if ctx is not None:
                ctx.__exit__(None, None, None)
        t1 = time.perf_counter()
        if out is None:
            return window.Request(i, t0, t1, 0, [0], 0, 0.0, True, traced, sp, None)
        steps = out.steps.tolist() if isinstance(out.steps, torch.Tensor) else list(out.steps)
        out.steps = steps
        return window.Request(i, t0, t1, len(steps), steps, max(steps), float(out.runtime),
                              failed or out.failed, traced, sp, out)

    # Warm-up: one request of the cell's own shapes, from a stream of its own.
    warm_stream = fam.requests(cfg, trf, seed ^ 0x3A3A, pool)
    call(pool, next(warm_stream))
    _sync(dev)
    setup_s = time.perf_counter() - t_start
    log(f"# set-up {setup_s:.3f} s: pool made at {t_pool:.3f} s, the port imported and the "
        f"warm request done after {setup_s - t_pool:.3f} s more")

    cap = None
    if trace:
        cap = tracing.Capture(getattr(fam, "counters", None))
        win = window.run(issue, seconds, trace_at=trf.get("trace_at", 0.5),
                         trace_seconds=trf.get("trace_seconds", 1.0),
                         start_trace=cap.start, stop_trace=cap.stop)
    else:
        win = window.run(issue, seconds)
    dinfo = devinfo.describe(dev, cell.chips)

    reqs = win.requests
    failed = sum(r.failed for r in reqs)
    ok_reqs = [r for r in reqs if not r.failed]
    checked = [ok_reqs[i] for i in checked_indices(seed, ok_reqs, trf["checked"])]
    for r in reqs:
        if all(r is not c for c in checked):
            r.outcome = None
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    # The comparison, after the window and the memory reading.
    port_out, ref_out = [], []
    for r in checked:
        o = r.outcome
        port_out.append((o.x, o.z, o.u, r.steps))
        ref_out.append(fam.reference(cfg, pool, r.spec, stop_at=r.steps))
    values = compare.numbers(port_out, ref_out) if checked else {}
    correct, checks = compare.verdict(values, cell.limits, failed)

    e2e = window.end_to_end(win)
    log(f"# window {e2e['window_s']:.3f} s, {e2e['requests']} requests "
        f"({failed} failed), {sum(r.instances for r in reqs)} instances; "
        f"p95 over {e2e['requests']} request times, p50 {e2e['solve_ms_p50']:.3f} ms; "
        f"{sum(1 for r in reqs for k in r.steps if k >= cfg['maxiters'])} "
        f"instances at the step cap; {len(checked)} requests checked "
        f"({sum(r.instances for r in checked)} instances)")
    sub = [r.substeps for r in ok_reqs]
    if sub:
        log(f"# loop steps a request: mean {sum(sub) / len(sub):.2f}, min {min(sub)}, "
            f"max {max(sub)}; set-up a request (wall less runtime): mean "
            f"{1e3 * sum(r.wall - r.runtime for r in ok_reqs) / len(ok_reqs):.3f} ms")
    metrics, breakdown = {}, None
    if not trace:
        known = dict(e2e, setup_s=setup_s)
        for m in cell.end_to_end:
            metrics[m.name] = {"value": known[m.name], "unit": m.unit}
    else:
        traced = [r for r in reqs if r.traced]
        run = RunData(cfg, trf, fam, reqs, traced, cap.summary)
        if len(cap.summary.requests) != len(traced):
            log(f"# trace holds {len(cap.summary.requests)} request spans for "
                f"{len(traced)} traced requests")
        for m in cell.per_layer:
            v = m.module.read(run)
            if v is not None:
                metrics[m.name] = {"value": v, "unit": m.unit}
        for note in run.notes:
            log(f"# {note}")
        lo, hi = cap.summary.span
        dinfo["busy_s"] = tracing.union_seconds(cap.summary.device, lo, hi)
        dinfo["window_s"] = hi - lo
        breakdown = {"device_ops": tracing.top_device_ops(cap.summary),
                               "idle_gaps": tracing.idle_gaps(cap.summary)}
        log(f"# traced {len(traced)} requests over {hi - lo:.3f} s; engine loops found in "
            f"{sum(e is not None for e in cap.summary.engine)}; kernels "
            f"{len(cap.summary.kernels)}, host launch calls {len(cap.summary.launches)}")
        if cap.counters is not None:
            log(f"# launch counters over the traced requests: {cap.counters}; kernels in the "
                f"trace by name: " + ", ".join(
                    f"{k} {sum(1 for s in cap.summary.kernels if k in s.name)}"
                    for k in cap.counters))
    result = {"correct": correct, "attempted": len(reqs), "failed": failed,
              "metrics": metrics, "device": dinfo}
    if breakdown is not None:
        result["breakdown"] = breakdown
    result["checks"] = checks
    return result


def main(args, t_start: float, root: Path = spec.ROOT) -> int:
    """The command line's run: refuse without enough cards, run, refuse
    if JAX or the JAX package was loaded, print the result."""
    cell = spec.cell(args.workload, root)
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"perfbench: {args.workload} needs {cell.chips} CUDA device(s); "
              f"torch sees {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    configure_caches(root)
    dev = torch.device("cuda", 0)
    torch.ones(1, device=dev)
    print(f"# torch imported and CUDA initialised at {time.perf_counter() - t_start:.3f} s")
    print(f"# {devinfo.smi(0)}")
    print(f"# torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(dev)}")
    print(f"# host: {os.cpu_count()} CPUs, torch's intra-op threads {torch.get_num_threads()} "
          f"(the libraries' defaults)")
    bench = spec.load_benchmark(root)
    print("# bounds: " + ", ".join(f"{m['name']} {m['bound']}" for m in bench["end_to_end"]
                                   if any(m['name'] == e.name for e in cell.end_to_end)))
    print(f"# {cell.family.working_set(cell.config)}")
    result = run_cell(cell, args.seed, args.seconds, bool(args.trace), dev, t_start)
    print(f"# after the run: {devinfo.smi(0)}")
    bad = forbidden_modules()
    if bad:
        print(f"perfbench: the process loaded {bad}; the benchmark measures admm_tpu_torch "
              f"alone", file=sys.stderr)
        return 3
    print(json.dumps(result))
    sys.stdout.flush()
    for name, c in result["checks"].items():
        print(f"{name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    print(f"correct {result['correct']}", file=sys.stderr)
    return 0
