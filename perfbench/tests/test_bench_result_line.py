"""The result line's keys, and the refusals: no card, JAX loaded."""

import json
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from benchlib import runner, spec

RUN = Path(__file__).resolve().parents[1] / "run.py"


def test_result_has_the_five_keys_and_checks_last(small_root):
    c = spec.cell("lasso_boyd_1500x5000.solve", small_root)
    res = runner.run_cell(c, 2**33 + 1, 0.3, False, torch.device("cpu"), 0.0, log=lambda s: None)
    assert list(res) == ["correct", "attempted", "failed", "metrics", "device", "checks"]
    assert res["correct"] is True and res["failed"] == 0 and res["attempted"] >= 1
    assert set(res["metrics"]) == {"solves_per_s", "iter_per_s", "solve_ms_p95", "setup_s"}
    assert all(set(m) == {"value", "unit"} for m in res["metrics"].values())
    assert set(res["device"]) == {"platform", "kind", "count", "memory_peak_bytes"}
    assert set(res["checks"]) == {"iterate_gap", "stop_lag"}
    json.dumps(res)


def test_traced_run_reports_only_per_layer_metrics(small_root):
    c = spec.cell("tv1d_65536.solve", small_root)
    res = runner.run_cell(c, 5, 0.4, True, torch.device("cpu"), 0.0, log=lambda s: None)
    assert list(res)[-1] == "checks" and "breakdown" in res
    assert set(res["metrics"]) <= {m.name for m in c.per_layer}
    assert {"setup_ms_per_solve", "steps_per_solve"} <= set(res["metrics"])
    assert {"busy_s", "window_s"} <= set(res["device"])


def test_no_card_no_result():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    out = subprocess.run([sys.executable, str(RUN), "--workload", "tv1d_65536.solve",
                          "--seed", "1", "--seconds", "1", "--trace", "0"],
                         capture_output=True, text=True, env=env, timeout=300,
                         cwd=str(RUN.parents[1]))
    assert out.returncode != 0
    assert not any(line.startswith("{") for line in out.stdout.splitlines())


def test_forbidden_modules_compare_whole_top_level_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "admm_tpu_torch_lookalike", object())
    assert runner.forbidden_modules() == [m for m in runner.forbidden_modules()
                                          if m.split(".")[0] in runner.FORBIDDEN]
    assert "admm_tpu_torch_lookalike" not in runner.forbidden_modules()
    monkeypatch.setitem(sys.modules, "jaxlib.fake", object())
    assert "jaxlib.fake" in runner.forbidden_modules()


@pytest.mark.gpu
def test_gpu_cell_runs_on_the_card(cuda, small_root):
    pytest.importorskip("torch")
    c = spec.cell("lasso_boyd_1500x5000.solve", small_root)
    res = runner.run_cell(c, 7, 1.0, False, cuda, 0.0, log=lambda s: None)
    assert res["correct"] and res["device"]["platform"] == "gpu"
