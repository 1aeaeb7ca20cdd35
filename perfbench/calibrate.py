#!/usr/bin/env python3
"""Readings that the limits of ``perfbench/limits/<cell>.json`` are set
from: the numbers compared (``benchlib.compare``) for the port on many
seeds, and for each control in the port's place on a few, in one process.

    python3 perfbench/calibrate.py --workload <cell> --seeds 11,12,... \
        --control-seeds 21,22,23 --seconds 3 [--out FILE]

Each seed runs the cell's set-up and a short window at the cell's own
load, then the comparison, exactly as ``run.py`` does; a control is the
system of ``controls()`` of the cell's family (the reference in the
nearest precision below the configuration's, or the port's own path in
that precision).  The benchmark's own runs never run a control.  Prints
one JSON line per reading and a summary line; with ``--out`` writes
them there too.  Runs on the card, and fails without one.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

HERE = Path(__file__).resolve().parent
sys.path.insert(0, str(HERE))
sys.path.insert(1, str(HERE.parent))


def readings(cell, seeds, seconds, dev, system=None, name="port", log=print):
    from benchlib import runner

    out = []
    for seed in seeds:
        res = runner.run_cell(cell, seed, seconds, False, dev, time.perf_counter(),
                              system=system, log=log)
        row = {"system": name, "seed": seed, "correct": res["correct"],
               "attempted": res["attempted"], "failed": res["failed"],
               **{k: v["value"] for k, v in res["checks"].items()}}
        log(json.dumps(row))
        out.append(row)
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", default="", help="comma-separated seeds for the port")
    ap.add_argument("--control-seeds", default="", help="comma-separated seeds for the controls")
    ap.add_argument("--seconds", type=float, default=3.0)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)

    import torch

    from benchlib import runner, spec

    cell = spec.cell(args.workload)
    if not torch.cuda.is_available():
        print("calibrate: no CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    runner.configure_caches(spec.ROOT)
    seeds = [int(s) for s in args.seeds.split(",") if s]
    cseeds = [int(s) for s in args.control_seeds.split(",") if s]
    rows = readings(cell, seeds, args.seconds, dev)
    controls = cell.family.controls(cell.config, cell.traffic)
    for name, system in controls.items():
        rows += readings(cell, cseeds, args.seconds, dev, system=system, name=name)
    summary = {"workload": args.workload, "device": torch.cuda.get_device_name(dev)}
    for sysname in ["port", *controls]:
        got = [r for r in rows if r["system"] == sysname]
        for key in ("iterate_gap", "stop_lag"):
            vals = [r[key] for r in got if key in r]
            if vals:
                summary[f"{sysname}.{key}"] = {"min": min(vals), "max": max(vals), "n": len(vals)}
    print(json.dumps(summary))
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        with open(args.out, "a") as f:
            for r in rows + [summary]:
                f.write(json.dumps(r) + "\n")
    bad = runner.forbidden_modules()
    if bad:
        print(f"calibrate: the process loaded {bad}", file=sys.stderr)
        return 3
    return 0


if __name__ == "__main__":
    sys.exit(main())
