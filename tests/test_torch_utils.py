"""The port's utilities (``admm_tpu_torch/utils``): the report, checkpoint
and profiling cases of tests/test_utils.py, tests/test_checkpoint.py and
tests/test_profiling_scaling.py on the CPU (the orbax cases also in
tests/test_torch_checkpoint_sharded.py, the scaling ones in
tests/test_torch_scaling.py), the report's text against
admm_tpu's, and npz checkpoints crossing between the two packages both
ways.  Plot cases skip where matplotlib is not installed.  f64.
"""

import sys

import numpy as np
import pytest
import torch

from admm_tpu_torch import ADMMConfig, Hooks, admm
from admm_tpu_torch.models.model import make_prox_ops, model
from admm_tpu_torch.utils import (load_state, load_state_orbax, save_state, save_state_orbax,
                                  showresults)

torch.set_num_threads(1)


def _model_problem(seed, m=32, n=24):
    rng = np.random.default_rng(seed)
    P, Q = rng.standard_normal((m, n)), rng.standard_normal((m, n))
    return P, Q, rng.standard_normal(m), rng.standard_normal(m)


def test_showresults_text_report():
    res = model(*_model_problem(0), ADMMConfig(objevals=True, maxiters=2000, convtest=True),
                device="cpu")
    out = []
    text = showresults(res, {"solver": "model", "trueobjopt": 1.23, "failed": False},
                       print_fn=out.append)
    assert "ADMM objective" in text and "steps" in text and "PASSED: True" in text
    assert out


def test_showresults_text_equals_admm_tpu():
    # Same instance, same results fields: the same lines but the runtimes.
    import admm_tpu.utils as jutils
    from admm_tpu import ADMMConfig as JConfig
    from admm_tpu.models.model import model as jmodel

    kw = dict(objevals=True, maxiters=2000, convtest=True)
    test = {"solver": "model", "trueobjopt": 1.23, "failed": True, "failreason": "why"}
    ours = showresults(model(*_model_problem(0), ADMMConfig(**kw), device="cpu"), test,
                       print_fn=lambda *_: None)
    ref = jutils.showresults(jmodel(*_model_problem(0), JConfig(**kw)), test,
                             print_fn=lambda *_: None)
    keep = lambda t: [ln for ln in t.splitlines() if "runtime" not in ln]  # noqa: E731
    assert keep(ours) == keep(ref)


def test_plot_without_matplotlib_raises_a_clear_import_error(monkeypatch):
    res = model(*_model_problem(1), ADMMConfig(maxiters=200), device="cpu")
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    with pytest.raises(ImportError, match="needs matplotlib"):
        showresults(res, save_plots="never.png", print_fn=lambda *_: None)


def test_showresults_plots(tmp_path):
    pytest.importorskip("matplotlib")
    res = model(*_model_problem(1), ADMMConfig(objevals=True, maxiters=2000, convtest=True),
                device="cpu")
    path = tmp_path / "conv.png"
    showresults(res, save_plots=str(path), print_fn=lambda *_: None)
    assert path.exists() and path.stat().st_size > 0


def test_showresults_plots_bound_overlays():
    pytest.importorskip("matplotlib")
    from admm_tpu_torch.utils.report import _plot

    res = model(*_model_problem(2), ADMMConfig(objevals=True, maxiters=2000, fast=True,
                                               fasttype="weak"), device="cpu")
    fig = _plot(res, None, show=False, save=None)
    by_title = {ax.get_title(): ax for ax in fig.axes}
    prim = by_title["primal norm"]
    assert "tolerance bound" in [ln.get_label() for ln in prim.get_lines()]
    assert prim.get_legend() is not None
    if "dual norm" in by_title:
        assert "tolerance bound" in [ln.get_label() for ln in by_title["dual norm"].get_lines()]
    dv = by_title.get("accelerated d-values")
    assert dv is not None
    assert any(np.allclose(ln.get_ydata(), res.config.dvaltol)
               for ln in dv.get_lines() if len(np.atleast_1d(ln.get_ydata())))


def test_showresults_tv_signal_overlay(tmp_path):
    pytest.importorskip("matplotlib")
    from admm_tpu_torch.testers import totalvariationtest

    res, test = totalvariationtest(0, 128, quiet=True, device="cpu")
    path = tmp_path / "tv.png"
    showresults(res, test, save_plots=str(path), print_fn=lambda *_: None)
    assert path.exists() and (tmp_path / "tv_signal.png").exists()


def test_solvertester_svm_two_curve_plot(tmp_path):
    pytest.importorskip("matplotlib")
    from admm_tpu_torch.testers.solvertester import _plot as _sweep_plot
    from admm_tpu_torch.testers.solvertester import solvertester

    path = tmp_path / "svm_sweep.png"
    rep = solvertester("linearsvm", minscale=4, maxscale=4, trials=1, seed=11,
                       save_plot=str(path), device="cpu")
    assert rep.runtimes01 is not None and np.all(np.isfinite(rep.runtimes01))
    assert path.exists() and path.stat().st_size > 0
    fig = _sweep_plot(rep, show=False, save=None)
    labels = [ln.get_label() for ln in fig.axes[0].get_lines()]
    assert "hinge loss" in labels and "0-1 loss" in labels


# ---- checkpoints -----------------------------------------------------------

def _model_solve(P, Q, r, s, cfg, **start):
    n = P.shape[1]
    pf, pg, obj, data = make_prox_ops(*(torch.from_numpy(a) for a in (P, Q, r, s)), cfg)
    return admm(pf, pg, cfg, A=1.0, B=-1.0, c=0.0, m=n, data=data, dtype=torch.float64,
                device="cpu", **start)


def test_save_and_resume(tmp_path):
    P, Q, r, s = _model_problem(0, 64, 48)
    truex = np.linalg.solve(P.T @ P + Q.T @ Q, P.T @ r + Q.T @ s)
    cfg = ADMMConfig(maxiters=10000)
    partial_ = _model_solve(P, Q, r, s, ADMMConfig(maxiters=30, domaxiters=True))
    ckpt = tmp_path / "state.npz"
    save_state(partial_, ckpt)
    state = load_state(ckpt)
    assert state["steps"] == 30
    resumed = _model_solve(P, Q, r, s, cfg, x0=state["x0"], z0=state["z0"], u0=state["u0"])
    cold = _model_solve(P, Q, r, s, cfg)
    assert resumed.steps < cold.steps
    np.testing.assert_allclose(resumed.xopt.numpy(), truex, atol=1e-2)


def test_extensionless_path_round_trips(tmp_path):
    res = _model_solve(*_model_problem(3), ADMMConfig(maxiters=20, domaxiters=True))
    save_state(res, tmp_path / "state")
    assert (tmp_path / "state.npz").exists()
    assert np.array_equal(load_state(tmp_path / "state")["x0"], res.xopt.numpy())


def test_admm_tpu_checkpoint_resumes_in_the_port(tmp_path):
    from admm_tpu import ADMMConfig as JConfig
    from admm_tpu import admm as jadmm
    from admm_tpu.models.model import make_prox_ops as jops
    from admm_tpu.utils import save_state as jsave

    P, Q, r, s = _model_problem(4, 64, 48)
    pf, pg, _, data = jops(P, Q, r, s, JConfig(maxiters=10000))
    jpart = jadmm(pf, pg, JConfig(maxiters=30, domaxiters=True), A=1.0, B=-1.0, c=0.0, m=48,
                  data=data)
    jsave(jpart, tmp_path / "jax.npz")
    state = load_state(tmp_path / "jax.npz")
    assert state["steps"] == 30 and state["rho"] == 1.0
    np.testing.assert_array_equal(state["x0"], np.asarray(jpart.xopt))
    # Resumed here, the 30 steps count: the rest of the solve equals the
    # port's own 30-step resume.
    ours = _model_solve(P, Q, r, s, ADMMConfig(maxiters=30, domaxiters=True))
    cfg = ADMMConfig(maxiters=10000)
    from_jax = _model_solve(P, Q, r, s, cfg, x0=state["x0"], z0=state["z0"], u0=state["u0"])
    from_port = _model_solve(P, Q, r, s, cfg, x0=ours.xopt, z0=ours.zopt, u0=ours.uopt)
    assert from_jax.steps == from_port.steps < _model_solve(P, Q, r, s, cfg).steps
    np.testing.assert_allclose(from_jax.xopt.numpy(), from_port.xopt.numpy(), rtol=1e-9,
                               atol=1e-12)


def test_port_checkpoint_resumes_in_admm_tpu(tmp_path):
    from admm_tpu import ADMMConfig as JConfig
    from admm_tpu import admm as jadmm
    from admm_tpu.models.model import make_prox_ops as jops
    from admm_tpu.utils import load_state as jload

    P, Q, r, s = _model_problem(5, 64, 48)
    part = _model_solve(P, Q, r, s, ADMMConfig(maxiters=30, domaxiters=True))
    save_state(part, tmp_path / "port")
    state = jload(tmp_path / "port")
    assert state["steps"] == 30
    np.testing.assert_array_equal(np.asarray(state["u0"]), part.uopt.numpy())
    pf, pg, _, data = jops(P, Q, r, s, JConfig(maxiters=10000))
    run = lambda **st: jadmm(pf, pg, JConfig(maxiters=10000), A=1.0, B=-1.0, c=0.0, m=48,  # noqa: E731
                             data=data, **st)
    resumed = run(x0=state["x0"], z0=state["z0"], u0=state["u0"])
    assert resumed.steps < run().steps
    truex = np.linalg.solve(P.T @ P + Q.T @ Q, P.T @ r + Q.T @ s)
    np.testing.assert_allclose(np.asarray(resumed.xopt), truex, atol=1e-2)


def test_orbax_checkpoints_wait_for_slice_10(tmp_path):
    # The sharded checkpoint names (a format of the port's own): a serial
    # solve's state round-trips with load_state's keys and values
    # (tests/test_torch_checkpoint_sharded.py holds the per-shard state
    # against admm_tpu's orbax checkpoints).
    res = _model_solve(*_model_problem(6), ADMMConfig(maxiters=5, domaxiters=True))
    save_state_orbax(res, tmp_path / "o")
    state = load_state_orbax(tmp_path / "o")
    assert state["steps"] == 5 and state["rho"] == float(res.rho_final)
    for key, name in (("x0", "xopt"), ("z0", "zopt"), ("u0", "uopt")):
        np.testing.assert_array_equal(state[key], getattr(res, name).numpy())
    assert "xi" not in state


# ---- profiling -------------------------------------------------------------

def test_iteration_rate():
    from admm_tpu_torch.utils.profiling import iteration_rate

    x = torch.ones(64)
    assert iteration_rate(lambda: x * 2.0, warmup=1, repeats=3) > 0


def test_profiler_trace(tmp_path):
    from admm_tpu_torch.utils.profiling import trace

    with trace(str(tmp_path)):
        _model_solve(*_model_problem(7), ADMMConfig(maxiters=5, domaxiters=True))
    out = tmp_path / "trace.json"
    assert out.exists() and "traceEvents" in out.read_text()
