"""The port's command-line interface (admm_tpu_torch/__main__.py), the
counterpart of admm_tpu/__main__.py: ``list`` prints admm_tpu's solvers,
``demo``, ``test`` and ``sweep --smoke`` run on ``--device cpu``,
``matrix`` and ``sweep`` write their own files by default, and
``scaling`` runs its sweep and its cost model on ``--device cpu``."""

import contextlib
import io
import json

import pytest
import torch

from admm_tpu.__main__ import main as j_main
from admm_tpu_torch.__main__ import main, parser

torch.set_num_threads(1)


def _stdout(fn, argv):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = fn(argv)
    return rc, out.getvalue()


def test_list_equals_admm_tpus():
    assert _stdout(main, ["list"]) == _stdout(j_main, ["list"])


@pytest.mark.parametrize("solver", ["lasso", "linearsvm"])
def test_demo_runs_on_the_cpu(solver):
    rc, text = _stdout(main, ["demo", solver, "--device", "cpu"])
    assert rc == 0 and "PASSED: True" in text


def test_test_command_runs_on_the_cpu():
    rc, text = _stdout(main, ["test", "lasso", "--minscale", "3", "--maxscale", "4",
                              "--trials", "1", "--seed", "0", "--device", "cpu"])
    assert rc == 0 and "solvertester: lasso (all passed)" in text


def test_sweep_smoke_on_the_cpu(tmp_path):
    out = tmp_path / "sweep.json"
    rc, text = _stdout(main, ["sweep", "--smoke", "--device", "cpu", "--out", str(out)])
    doc = json.loads(out.read_text())
    assert doc["platform"] == "cpu" and doc["smoke"] and doc["trials"] == 1
    from admm_tpu_torch.testers.solvertester import _TESTERS

    assert [f["solver"] for f in doc["families"]] == list(_TESTERS)
    assert rc == (0 if doc["all_green"] else 1)
    assert all(len(f["failures"]) == 1 for f in doc["families"])


def test_default_outputs_are_not_admm_tpus_files():
    p = parser()
    assert p.parse_args(["matrix"]).out == "BENCH_MATRIX_TORCH.json"
    assert p.parse_args(["sweep"]).out == "BENCH_SWEEP_TORCH.json"
    assert p.parse_args(["matrix"]).device == "cuda"


def test_scaling_waits_for_slice_10(capsys):
    # scaling: the sweep over 1 and 2 stacked shards, one JSON line each
    # and the efficiency line, and the cost model's lines under --predict.
    import json

    argv = ["scaling", "--rows-per-shard", "64", "--cols", "16", "--iters", "10",
            "--device", "cpu"]
    assert main(argv + ["--devices", "2"]) == 0
    lines = [json.loads(x) for x in capsys.readouterr().out.splitlines()]
    assert [x.get("devices") for x in lines[:2]] == [1, 2]
    assert lines[2]["metric"] == "weak_scaling_efficiency" and lines[2]["efficiency"]["1"] == 1.0
    assert main(argv + ["--predict"]) == 0
    metrics = [json.loads(x)["metric"] for x in capsys.readouterr().out.splitlines()]
    assert {"collective_roundtrip", "measured_t_compute", "predicted_weak_scaling_efficiency",
            "weak_scaling_breakeven"} == set(metrics)
