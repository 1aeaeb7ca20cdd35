"""The port's model problem (admm_tpu_torch/models/model.py) against
admm_tpu's ``model`` in f64, each package doing its own setup, and on
admm_tpu's setup carried across (``convert.model_data``); plus
tests/test_config_fuzz.py's lasso and model sweeps of random valid
configurations through both packages."""

import importlib

import numpy as np
import pytest
import torch

from admm_tpu import ADMMConfig as JaxConfig
from admm_tpu import lasso as jax_lasso
from admm_tpu.models.model import make_prox_ops as jax_model_ops
from admm_tpu.models.model import model as jax_model
from admm_tpu_torch import ADMMConfig, lasso, model
from admm_tpu_torch.convert import model_data, numpy_state
from admm_tpu_torch.ops.solve import SymShiftSolver

torch.set_num_threads(1)
model_mod = importlib.import_module("admm_tpu_torch.models.model")


def _instance(seed=7, m=64, n=48):
    rng = np.random.default_rng(seed)
    P, Q = rng.standard_normal((m, n)), rng.standard_normal((m, n))
    r, s = rng.standard_normal(m), rng.standard_normal(m)
    truex = np.linalg.solve(P.T @ P + Q.T @ Q, P.T @ r + Q.T @ s)
    return P, Q, r, s, truex


def _assert_close_runs(res, jres, rtol=1e-9):
    assert res.steps == jres.steps and res.diverged == bool(jres.diverged)
    np.testing.assert_allclose(res.rho_final, float(jres.rho_final), rtol=1e-12)
    for name in ("xopt", "zopt", "uopt"):
        np.testing.assert_allclose(getattr(res, name).numpy(),
                                   np.asarray(getattr(jres, name)), rtol=rtol, atol=rtol / 10)
    for name in jres.hist:
        ref = jres.trace(name)
        scale = np.max(np.abs(ref[0])) or np.nanmax(np.abs(ref))
        np.testing.assert_allclose(res.trace(name), ref, rtol=0, atol=1e-8 * scale)


@pytest.mark.parametrize("kw", [
    dict(),
    dict(objevals=True, unroll=4),
    dict(adaptive=True, convtest=True, maxiters=500),
    dict(rbadaptive=True, rho=0.01),
    dict(stopcond="both", convtest=True, relax=1.4),
])
def test_model_matches_jax_f64(kw):
    P, Q, r, s, truex = _instance()
    cfg = dict(dict(maxiters=2000), **kw)
    jres = jax_model(P, Q, r, s, JaxConfig(**cfg))
    res = model(P, Q, r, s, ADMMConfig(**cfg), device="cpu")
    assert res.xopt.dtype == torch.float64 and res.xopt.device.type == "cpu"
    # Each package factorizes on its own (eigh in f64): the iterates agree
    # to the conditioning of the setup, not bit for bit.
    _assert_close_runs(res, jres)
    if not kw.get("adaptive"):
        assert res.steps < cfg["maxiters"]
        assert np.linalg.norm(res.xopt.numpy() - truex) < 1e-2
    if res.objopt is not None:
        np.testing.assert_allclose(res.objopt, float(jres.objopt), rtol=1e-10)


@pytest.mark.parametrize("dynamic", [False, True])
def test_model_state_round_trips(dynamic):
    P, Q, r, s, _ = _instance(3, 40, 24)
    jcfg = JaxConfig(rbadaptive=True) if dynamic else JaxConfig(rho=0.7)
    *_, jdata = jax_model_ops(P, Q, r, s, jcfg)
    state = numpy_state(jdata, x0=np.ones(24))
    data, warm = model_data(state)
    assert set(warm) == {"x0"}
    if dynamic:
        assert isinstance(data["solP"], SymShiftSolver) and isinstance(data["solQ"], SymShiftSolver)
        assert {"solP.V", "solP.w", "solQ.V", "solQ.w"} <= set(state)
    else:
        assert {"PtPinv", "QtQinv"} <= set(state)
    for key, val in state.items():
        head, _, field = key.partition(".")
        got = getattr(data[head], field) if field else data.get(key, warm.get(key))
        assert got.dtype == torch.float64
        np.testing.assert_array_equal(got.numpy(), val)
    back = numpy_state(data, **warm)
    assert set(back) == set(state)
    for key in state:
        np.testing.assert_array_equal(back[key], state[key])
    # The port's own setup agrees with the carried one to solver precision.
    tdata = model_mod.make_prox_ops(*(torch.from_numpy(a) for a in (P, Q, r, s)),
                                    ADMMConfig(rbadaptive=True) if dynamic else ADMMConfig(rho=0.7))[3]
    assert set(tdata) == set(data)
    key = "solP" if dynamic else "PtPinv"
    b = torch.from_numpy(np.random.default_rng(0).standard_normal(24))
    if dynamic:
        np.testing.assert_allclose(tdata[key].solve(b, 0.3).numpy(),
                                   data[key].solve(b, 0.3).numpy(), rtol=1e-10, atol=1e-12)
    else:
        np.testing.assert_allclose(tdata[key].numpy(), data[key].numpy(), rtol=1e-10,
                                   atol=1e-12)


def test_model_accepts_tensors_and_float32():
    P, Q, r, s, truex = _instance()
    t = [torch.from_numpy(a).float() for a in (P, Q, r, s)]
    res = model(*t, ADMMConfig(maxiters=2000))
    assert res.xopt.dtype == torch.float32 and res.xopt.device == t[0].device
    assert np.linalg.norm(res.xopt.double().numpy() - truex) < 1e-2
    assert res.solverruntime >= res.runtime > 0


def test_model_demo_mode_raises():
    with pytest.raises(NotImplementedError, match="slice 11"):
        model()


# ---- tests/test_config_fuzz.py: lasso and model --------------------------


def _random_config(rng):
    """test_config_fuzz.py's draw, AA included: every runner of
    admm_tpu takes AA; only its SVM wrappers, which force
    stopcond='both', reject it."""
    cfg = dict(
        rho=float(rng.choice([0.5, 1.0, 2.0])),
        maxiters=int(rng.choice([60, 150])),
        relax=float(rng.choice([1.0, 1.0, 0.7, 1.5])),
        unroll=int(rng.choice([1, 1, 3, 4])),
        nanguard=bool(rng.random() < 0.5),
        domaxiters=bool(rng.random() < 0.2),
        stallwindow=int(rng.choice([0, 0, 0, 30])),
        quiet=True,
    )
    mode = rng.choice(["plain", "fast_w", "fast_s", "adaptive", "rb", "aa"])
    if mode == "fast_w":
        cfg.update(fast=True, fasttype="weak")
    elif mode == "fast_s":
        cfg.update(fast=True, fasttype="strong")
    elif mode == "adaptive":
        cfg.update(adaptive=True, convtest=True)
    elif mode == "rb":
        cfg.update(rbadaptive=True)
    elif mode == "aa":
        cfg.update(anderson=int(rng.choice([2, 5, 12])))
    cfg["stopcond"] = str(rng.choice(
        ["standard", "both"] + (["hnorm"] if mode != "fast_w" else []))
    ) if mode != "aa" else "standard"
    if mode == "adaptive":
        cfg["stopcond"] = "both"
    return cfg


def _fuzz_checks(res, jres, cfg):
    config = ADMMConfig(**cfg)
    assert 1 <= res.steps <= config.maxiters
    # A clean solve or an explicit divergence flag, never silent NaNs.
    assert res.diverged or bool(torch.isfinite(res.xopt).all())
    if config.domaxiters and not res.diverged and config.alg != 2:
        assert res.steps == config.maxiters
    # The same run as admm_tpu's: each package does its own setup, so the
    # iterates agree to the setup's rounding.
    assert res.steps == jres.steps and res.diverged == bool(jres.diverged)
    assert res.stalled == bool(jres.stalled)
    if not res.diverged:
        np.testing.assert_allclose(res.xopt.numpy(), np.asarray(jres.xopt), rtol=1e-7,
                                   atol=1e-8)


@pytest.mark.parametrize("trial", range(24))
def test_random_config_never_crashes_or_lies(trial):
    rng = np.random.default_rng(1000 + trial)
    cfg = _random_config(rng)
    D = rng.standard_normal((48, 24))
    s = rng.standard_normal(48)
    res = lasso(D, s, 0.15, ADMMConfig(**cfg), device="cpu")
    jres = jax_lasso(D, s, 0.15, JaxConfig(**cfg))
    _fuzz_checks(res, jres, cfg)


@pytest.mark.parametrize("trial", range(8))
def test_random_config_two_prox_problem(trial):
    rng = np.random.default_rng(2000 + trial)
    cfg = _random_config(rng)
    P = rng.standard_normal((40, 20))
    Q = rng.standard_normal((40, 20))
    r = rng.standard_normal(40)
    s = rng.standard_normal(40)
    res = model(P, Q, r, s, ADMMConfig(**cfg), device="cpu")
    jres = jax_model(P, Q, r, s, JaxConfig(**cfg))
    _fuzz_checks(res, jres, cfg)
