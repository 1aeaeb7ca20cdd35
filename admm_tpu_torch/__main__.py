"""Command-line interface (port of ``admm_tpu/__main__.py``).

    python -m admm_tpu_torch demo <solver>            run a solver's demo test
    python -m admm_tpu_torch test <solver> [opts]     solvertester scale sweep
    python -m admm_tpu_torch bench [--smoke]          headline benchmark
    python -m admm_tpu_torch matrix [--smoke]         per-solver timing + f32 matrix
    python -m admm_tpu_torch sweep [--smoke]          on-device solvertester sweep
    python -m admm_tpu_torch scaling [--devices N]    consensus weak scaling [--predict]
    python -m admm_tpu_torch list                     list solvers

Every command that solves runs on the CUDA device unless ``--device``
asks for another (``--device cpu``), as every entry point's ``device=``
does.  ``matrix`` and ``sweep`` write ``BENCH_MATRIX_TORCH.json`` and
``BENCH_SWEEP_TORCH.json`` by default (``admm_tpu``'s files are the TPU's).
``scaling`` runs ``benchmarks/scaling.py``: the sweep over 1, 2, 4, 8
stacked shards, or with ``--predict`` the collective microbench and the
cost model.
"""

from __future__ import annotations

import argparse

_SOLVERS = [
    "model", "lasso", "basispursuit", "totalvariation", "lad", "huberfit",
    "linearprogram", "quadraticprogram", "covarianceselection", "linearsvm",
]


def parser():
    """The CLI's argument parser."""
    p = argparse.ArgumentParser(prog="admm_tpu_torch")
    sub = p.add_subparsers(dest="cmd", required=True)

    def solving(command):
        command.add_argument("--device", default="cuda",
                             help="device to solve on (default: the CUDA device)")
        return command

    d = solving(sub.add_parser("demo", help="run a solver's zero-arg demo"))
    d.add_argument("solver", choices=_SOLVERS)

    t = solving(sub.add_parser("test", help="solvertester scale sweep"))
    t.add_argument("solver", choices=_SOLVERS)
    t.add_argument("--minscale", type=int, default=4)
    t.add_argument("--maxscale", type=int, default=6)
    t.add_argument("--trials", type=int, default=3)
    t.add_argument("--testtype", default="square",
                   choices=["square", "fat", "skinny", "morepos", "moreneg"])
    t.add_argument("--seed", type=int, default=None)

    b = solving(sub.add_parser("bench", help="headline benchmark (one JSON line)"))
    b.add_argument("--smoke", action="store_true")

    mx = solving(sub.add_parser("matrix", help="per-solver timing + f32 oracle accuracy matrix"))
    mx.add_argument("--smoke", action="store_true")
    mx.add_argument("--out", default="BENCH_MATRIX_TORCH.json")
    mx.add_argument("--steps", type=int, default=None, help="cap every row's timed steps")
    mx.add_argument("--rows", default=None, help="comma-separated row names to run alone")

    sw = solving(sub.add_parser(
        "sweep", help="on-device multi-scale solvertester sweep (all families)"))
    sw.add_argument("--smoke", action="store_true")
    sw.add_argument("--out", default="BENCH_SWEEP_TORCH.json")

    s = solving(sub.add_parser("scaling", help="consensus weak-scaling sweep"))
    s.add_argument("--devices", type=int, default=8)
    s.add_argument("--rows-per-shard", type=int, default=4096)
    s.add_argument("--cols", type=int, default=512)
    s.add_argument("--iters", type=int, default=300)
    s.add_argument("--predict", action="store_true",
                   help="collective microbench + interconnect cost-model prediction")
    s.add_argument("--t-compute-us", type=float, default=None)

    sub.add_parser("list", help="list available solvers")
    return p


def main(argv=None):
    args = parser().parse_args(argv)

    if args.cmd == "list":
        print("\n".join(_SOLVERS))
        return 0

    if args.cmd == "demo":
        import admm_tpu_torch

        getattr(admm_tpu_torch, args.solver)(device=args.device)
        return 0

    if args.cmd == "test":
        from admm_tpu_torch.testers import solvertester

        report = solvertester(
            args.solver, args.minscale, args.maxscale, args.trials,
            testtype=args.testtype, seed=args.seed, quiet=False, device=args.device,
        )
        return 1 if report.any_failed else 0

    if args.cmd == "bench":
        from admm_tpu_torch.benchmarks.headline import main as bench_main

        bench_main(smoke=args.smoke, device=args.device)
        return 0

    if args.cmd == "matrix":
        from admm_tpu_torch.benchmarks.matrix import main as matrix_main

        matrix_main(smoke=args.smoke, out_path=args.out, device=args.device, steps=args.steps,
                    only=None if args.rows is None else set(args.rows.split(",")))
        return 0

    if args.cmd == "sweep":
        from admm_tpu_torch.benchmarks.sweep import main as sweep_main

        doc = sweep_main(smoke=args.smoke, out_path=args.out, device=args.device)
        return 0 if doc["all_green"] else 1

    if args.cmd == "scaling":
        from admm_tpu_torch.benchmarks.scaling import main as scaling_main

        return scaling_main(args.devices, args.rows_per_shard, args.cols, args.iters,
                            args.predict, args.t_compute_us, args.device)

    return 1


if __name__ == "__main__":
    raise SystemExit(main())
