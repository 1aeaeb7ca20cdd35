"""Zero-argument demo mode of the port's solvers (tests/test_demo_mode.py):
each wrapper whose admm_tpu counterpart runs a tester runs the port's
tester with quiet=False, on the CPU here, prints the report and passes,
with the step count admm_tpu's demo gives."""

import pytest
import torch

import admm_tpu
import admm_tpu_torch

torch.set_num_threads(1)

WRAPPERS = ["basispursuit", "covarianceselection", "huberfit", "lad", "lasso",
            "linearprogram", "linearsvm", "logreg", "model", "quadraticprogram",
            "totalvariation"]


def test_solver_demo_mode(capsys):
    res = admm_tpu_torch.model(device="cpu")
    assert res.steps > 0
    assert "ADMM results" in capsys.readouterr().out
    res2 = admm_tpu_torch.lasso(device="cpu")
    assert res2.steps > 0


@pytest.mark.parametrize("name", WRAPPERS)
def test_every_demo_mode_runs_its_tester(capsys, name):
    res = getattr(admm_tpu_torch, name)(device="cpu")
    out = capsys.readouterr().out
    assert "ADMM results" in out and "PASSED: True" in out, out
    assert res.xopt.device.type == "cpu" and res.steps > 0
    ref = getattr(admm_tpu, name)()
    capsys.readouterr()
    assert res.steps == ref.steps
