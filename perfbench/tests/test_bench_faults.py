"""A run with the timed path broken underneath comes out not correct:
the harness's look for a card is skipped and the rest of a run is driven
on the CPU, once for each fault a cell can have.  One chip, so there is
no exchange between chips to leave out."""

import importlib

import pytest
import torch

from benchlib import runner, spec
from families.common import Outcome

CELLS = ["lasso_boyd_1500x5000.solve", "tv1d_65536.solve", "lasso_boyd_1500x5000.path100"]


def _run(root, name, system=None):
    c = spec.cell(name, root)
    return runner.run_cell(c, 2**31 + 77, 0.2, False, torch.device("cpu"), 0.0,
                           system=system, log=lambda s: None)


@pytest.mark.parametrize("name", CELLS)
def test_step_returning_its_state_unchanged(small_root, name, monkeypatch):
    port_lasso = importlib.import_module("admm_tpu_torch.models.lasso")
    port_tv = importlib.import_module("admm_tpu_torch.models.totalvariation")
    keep = lambda x, z, u, rho, d: x  # noqa: E731
    monkeypatch.setattr(port_lasso, "_prox_f_fat_static", keep)
    monkeypatch.setattr(port_tv, "_prox_f_cr", keep)
    assert _run(small_root, name)["correct"] is False


@pytest.mark.parametrize("name", CELLS)
def test_answer_altered_where_it_is_produced(small_root, name):
    c = spec.cell(name, small_root)
    port = c.family.port(c.config, c.traffic)

    def altered(pool, sp):
        out = port(pool, sp)
        x = out.x.clone()
        x[..., 0] += 1e-2 * torch.linalg.vector_norm(x, dim=-1)
        return Outcome(x, out.z, out.u, out.steps, out.runtime, out.failed)

    assert _run(small_root, name, altered)["correct"] is False


def test_half_the_lanes_left_out(small_root):
    name = "lasso_boyd_1500x5000.path100"
    c = spec.cell(name, small_root)
    port = c.family.port(c.config, c.traffic)

    def half(pool, sp):
        out = port(pool, type(sp)(sp.index, sp.entry, sp.lam[::2].contiguous()))
        rep = lambda t: t.repeat_interleave(2, dim=0)  # noqa: E731
        return Outcome(rep(out.x), rep(out.z), rep(out.u), rep(out.steps), out.runtime)

    assert _run(small_root, name, half)["correct"] is False


@pytest.mark.parametrize("name", CELLS)
def test_stop_reported_late(small_root, name):
    c = spec.cell(name, small_root)
    port = c.family.port(c.config, c.traffic)

    def late(pool, sp):
        out = port(pool, sp)
        steps = torch.as_tensor(out.steps) + 3
        return Outcome(out.x, out.z, out.u, steps, out.runtime, out.failed)

    assert _run(small_root, name, late)["correct"] is False
