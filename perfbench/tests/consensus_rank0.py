"""Rank 0 of the consensus family at a CPU size, for test_bench_consensus.py:
a copy of the benchmark under ``argv[1]`` with a tiny consensus cell,
then ``argv[2]``: ``run`` (the port's run and the bfloat16 reference's in
its place, through ``runner.run_cell``, then a normal exit) or ``die`` (the
pool made, then this process killed).  Prints one JSON line per step."""

import json
import os
import signal
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent
sys.path[:0] = [str(HERE.parent), str(HERE.parent.parent), str(HERE)]

import torch  # noqa: E402

from benchlib import runner, spec  # noqa: E402
from conftest import make_copy  # noqa: E402

NAME, CELL = "consensus_lasso_tiny", "consensus_lasso_tiny.lambda_grid_tiny"


def tiny_cell(root: Path):
    make_copy(root)
    pb = root / "perfbench"
    cfg = json.loads((pb / "configs" / "consensus_lasso_400000x8000.json").read_text())
    cfg.update(name=NAME, m=192, n=40, shards=8, density=0.2)
    (pb / "configs" / f"{NAME}.json").write_text(json.dumps(cfg))
    trf = json.loads((pb / "traffic" / "lambda_grid20.json").read_text())
    trf.update(trace_seconds=0.2)
    (pb / "traffic" / "lambda_grid_tiny.json").write_text(json.dumps(trf))
    limits = pb / "limits" / "consensus_lasso_400000x8000.lambda_grid20.json"
    (pb / "limits" / f"{CELL}.json").write_text(limits.read_text())
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": NAME, "source": "test", "file": f"perfbench/configs/{NAME}.json",
                             "reduced": ["m", "n", "shards"], "why": "test"})
    bench["workloads"].append({"name": CELL, "config": NAME, "traffic": "lambda_grid_tiny",
                               "chips": 4, "why": "test"})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    return spec.cell(CELL, root)


def main(root: Path, what: str):
    c = tiny_cell(root)
    cpu = torch.device("cpu")
    if what == "die":
        c.family.make_pool(c.config, c.traffic, 5, cpu)
        ranks = c.family._RANKS
        print(json.dumps({"helpers": [h.pid for h in ranks.helpers], "tmp": ranks.tmp}), flush=True)
        os.kill(os.getpid(), signal.SIGKILL)
    quiet = lambda s: None  # noqa: E731
    res = runner.run_cell(c, 2**31 + 9, 1.0, True, cpu, time.perf_counter(), log=quiet)
    ranks = c.family._RANKS
    bound = [sorted(os.sched_getaffinity(p)) for p in [os.getpid()] + [h.pid for h in ranks.helpers]]
    print(json.dumps({"port": res, "helpers": [h.pid for h in ranks.helpers],
                      "tmp": ranks.tmp, "bound": bound, "cores": ranks.cores}), flush=True)
    control = c.family.controls(c.config, c.traffic)["reference_bf16"]
    res = runner.run_cell(c, 12, 0.3, False, cpu, time.perf_counter(), system=control, log=quiet)
    print(json.dumps({"control": res}), flush=True)


if __name__ == "__main__":
    main(Path(sys.argv[1]), sys.argv[2])
