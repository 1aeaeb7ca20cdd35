"""The four-rank consensus cell on the CPU: the family's lockstep over
four gloo ranks through ``runner.run_cell`` at a tiny size, its helpers'
exits, the plain reference's imports, and the cell's four readers on a
canned trace (``data/canned_trace_consensus.json``: one request of four
sub-steps on rank 0, its consensus spans, NCCL kernels and the local
solves' kernels, every value below computed by hand from the file)."""

import json
import os
import shutil
import subprocess
import sys
import time
from pathlib import Path

import pytest

from benchlib import spec, trace
from benchlib.context import RunData
from benchlib.window import Request
from families import consensus_lasso as fam
from families.common import Spec

HERE = Path(__file__).resolve().parent
RANK0 = HERE / "consensus_rank0.py"
CELL = "consensus_lasso_400000x8000.lambda_grid20"
NEW = ["collective_pct", "collectives_per_step", "local_solve_roofline",
       "consensus_loop_idle_pct"]


def _gone(pid: int) -> bool:
    """Whether process ``pid`` has exited (a zombie counts as exited)."""
    try:
        with open(f"/proc/{pid}/stat") as f:
            return f.read().rsplit(")", 1)[1].split()[0] in ("Z", "X")
    except FileNotFoundError:
        return True


def _rank0(tmp_path, what):
    env = dict(os.environ, OMP_NUM_THREADS="1")
    out = subprocess.run([sys.executable, str(RANK0), str(tmp_path / "root"), what],
                         capture_output=True, text=True, timeout=120, env=env)
    lines = [json.loads(s) for s in out.stdout.splitlines() if s.startswith("{")]
    return out, lines


def test_four_gloo_ranks_run_the_cell_in_lockstep(tmp_path):
    out, lines = _rank0(tmp_path, "run")
    assert out.returncode == 0, out.stderr[-4000:]
    port, control = lines[0]["port"], lines[1]["control"]
    assert port["correct"] is True and port["failed"] == 0 and port["attempted"] >= 2
    # The reference in bfloat16 ran in the port's place on the same ranks
    # (a second pool), every request in step with the helpers, and is not
    # correct.
    assert control["failed"] == 0 and control["attempted"] >= 1
    assert control["correct"] is False
    assert control["checks"]["iterate_gap"]["value"] > control["checks"]["iterate_gap"]["limit"]
    # Each rank ran on the cores it was given.
    cores = lines[0]["cores"]
    assert cores is None or lines[0]["bound"] == cores
    # Told to stop at rank 0's exit, the helpers left and took the
    # rendezvous with them.
    assert all(_gone(p) for p in lines[0]["helpers"])
    assert not Path(lines[0]["tmp"]).exists()


def test_helpers_exit_when_rank_0_dies(tmp_path):
    out, lines = _rank0(tmp_path, "die")
    assert out.returncode == -9, out.stderr[-4000:]
    pids = lines[0]["helpers"]
    assert len(pids) == 3
    deadline = time.monotonic() + 30.0
    while not all(_gone(p) for p in pids) and time.monotonic() < deadline:
        time.sleep(0.5)
    shutil.rmtree(lines[0]["tmp"], ignore_errors=True)   # left by the killed rank 0
    assert all(_gone(p) for p in pids)


def test_core_sets_give_each_rank_whole_cores(tmp_path):
    # Eight CPUs: two packages of two cores, each core two threads
    # (CPU c is thread c // 4 of core c % 2 of package (c // 2) % 2).
    for c in range(8):
        topo = tmp_path / f"cpu{c}" / "topology"
        topo.mkdir(parents=True)
        (topo / "physical_package_id").write_text(f"{(c // 2) % 2}\n")
        (topo / "core_id").write_text(f"{c % 2}\n")
    sets = fam.core_sets(4, range(8), str(tmp_path))
    assert sets == [[0, 4], [1, 5], [2, 6], [3, 7]]
    assert fam.core_sets(2, range(8), str(tmp_path)) == [[0, 1, 4, 5], [2, 3, 6, 7]]
    assert fam.core_sets(5, range(8), str(tmp_path)) is None
    # Without topology files every CPU is a core of its own.
    assert fam.core_sets(4, [3, 1, 2, 0], str(tmp_path / "none")) == [[0], [1], [2], [3]]


def test_reference_loads_nothing_of_the_port():
    code = (f"import sys; sys.path[:0] = [{str(HERE.parent)!r}]\n"
            "import reference.consensus_lasso\n"
            "print(' '.join(sorted({m.split('.')[0] for m in sys.modules})))\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=300, cwd=str(HERE.parent.parent))
    assert out.returncode == 0, out.stderr
    tops = set(out.stdout.split())
    assert not tops & {"jax", "jaxlib", "flax", "admm_tpu", "admm_tpu_torch", "benchlib",
                       "families"}, tops


def test_cell_resolves_its_files():
    c = spec.cell(CELL)
    assert c.chips == 4 and c.family.__file__ == fam.__file__
    assert {m.name for m in c.end_to_end} == {"solves_per_s", "iter_per_s", "setup_s"}
    assert {m.name for m in c.per_layer} == set(NEW)
    assert c.config["shards"] % c.config["ranks"] == 0
    assert c.config["m"] % c.config["shards"] == 0
    assert {"iterate_gap", "stop_lag"} <= set(c.limits)


def test_local_solve_cost_counts_each_shards_least_inputs():
    cfg = spec.cell(CELL).config
    c = fam.local_solve(cfg)
    # 20 shards a rank, each D_i (5000 x 8000) and a triangular 5000 x 5000
    # factor (52.5e6 words, under n^2 = 64e6), plus its right-hand side and x_i
    words = 5000 * 8000 + 5000 * 5001 // 2 + 2 * 8000
    assert c.bytes == 20 * words * 4
    assert c.flops == 20 * (4.0 * 5000 * 8000 + 2.0 * 5000 * 5000)
    assert c.bound == "bytes"
    small = dict(cfg, m=80000, shards=80)      # 1000 x 8000 shards: still Woodbury
    wide = dict(cfg, m=800000, shards=80)      # 10000 x 8000: the n x n inverse is less
    assert fam.local_solve(small).bytes < c.bytes
    assert fam.local_solve(wide).bytes == 20 * (8000 * 8000 + 2 * 8000) * 4


CONFIG = {"m": 400, "n": 100, "shards": 8, "ranks": 4}


def _run(steps=(3,), failed=False, collectives=None):
    summary = trace.load(str(HERE / "data" / "canned_trace_consensus.json"))
    sp = Spec(0, 0, 0.1)
    sp.collectives = {"all_reduce": 8, "all_gather": 1} if collectives is None else collectives
    req = Request(0, 0.0, 1.0, 1, list(steps), max(steps), 0.0, failed, traced=True, spec=sp)
    return RunData(CONFIG, {}, fam, [req], [req], summary)


@pytest.mark.parametrize("name,value", [
    # loop 1100-1500 us; in each of its four sub-steps two all-reduce
    # kernels of 10 and 5 us (the all-gather at 1510-1520 follows it):
    # 60 of 400 us
    ("collective_pct", 100 * 60 / 400),
    # 8 all-reduce calls over 4 step spans
    ("collectives_per_step", 8 / 4),
    # the local solves' least time for the 3 steps needed over the kernels
    # launched inside step.xupdate: four GEMVs of 20 us and one 10-us
    # elementwise kernel, 90 us
    ("local_solve_roofline", 100 * 3 * fam.local_solve(CONFIG).seconds / 90e-6),
    # device busy in the loop: 20 + 10 + 5 + 5 us a sub-step and the first
    # sub-step's elementwise 10 us: 170 of 400 us
    ("consensus_loop_idle_pct", 100 * (1 - 170 / 400)),
])
def test_reader(name, value):
    assert spec.metric_module(name).read(_run()) == pytest.approx(value)


def test_notes():
    run = _run()
    for name in NEW:
        spec.metric_module(name).read(run)
    notes = "\n".join(run.notes)
    assert ("8 NCCL kernels in 1 loop spans of 1 requests, 60.000 us of 400.000 us; "
            "8 collective spans there, 7.000 us of host each") in notes
    assert "{'all_reduce': 8, 'all_gather': 1} over 1 requests, 4 sub-steps run for 3 steps" \
        in notes
    assert "over 90.000 us of device in 5 kernels of 4 sub-steps" in notes
    assert "1 loop spans, 400.000 us, the device busy 170.000 us of it" in notes


@pytest.mark.parametrize("name", NEW)
def test_readers_find_nothing_without_spans_or_requests(name):
    assert spec.metric_module(name).read(_run(failed=True)) is None
    older = trace.load(str(HERE / "data" / "canned_trace.json"))
    req = Request(0, 0.0, 1.0, 1, [2], 2, 0.0, False, traced=True, spec=Spec(0, 0, 0.1))
    run = RunData(CONFIG, {}, fam, [req], [req], older)
    assert spec.metric_module(name).read(run) is None
