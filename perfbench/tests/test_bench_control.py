"""The control: the reference in the nearest precision below the
configuration's, put in the port's place, must come out not correct
under the cell's limits, while the port comes out correct.  At CPU sizes;
the readings at the cells' own sizes on the card are in PERF.md."""

import pytest
import torch

from benchlib import runner, spec

CONTROLS = [("lasso_boyd_1500x5000.solve", "reference_tf32"),
            ("tv1d_65536.solve", "reference_bf16"),
            ("lasso_boyd_1500x5000.path100", "reference_tf32")]


@pytest.mark.parametrize("name,control", CONTROLS)
def test_control_is_not_correct(small_root, name, control):
    c = spec.cell(name, small_root)
    system = c.family.controls(c.config, c.traffic)[control]
    for seed in (11, 2**31 + 12):
        res = runner.run_cell(c, seed, 0.2, False, torch.device("cpu"), 0.0, system=system,
                              log=lambda s: None)
        assert res["correct"] is False, res["checks"]
        assert any(v["value"] > v["limit"] for v in res["checks"].values())


@pytest.mark.parametrize("name", [n for n, _ in CONTROLS])
def test_port_is_correct(small_root, name):
    c = spec.cell(name, small_root)
    for seed in (13, 2**31 + 14):
        res = runner.run_cell(c, seed, 0.2, False, torch.device("cpu"), 0.0, log=lambda s: None)
        assert res["correct"] is True, res["checks"]


def test_tf32_rounding():
    from reference.common import round_tf32

    x = torch.tensor([1.0, 1.0 + 2**-11, 1.0 + 2**-10, -3.0 - 2**-12, 1.0 + 2**-12])
    assert round_tf32(x).tolist() == [1.0, 1.0 + 2**-10, 1.0 + 2**-10, -3.0, 1.0]
