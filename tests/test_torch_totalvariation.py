"""The TV slice: the port's ``DiffOp``, ``totalvariation`` and
``totalvariation2d`` against admm_tpu's on the same numpy inputs in f64,
each package doing its own setup, and on admm_tpu's setup carried across
(``convert.tv_data`` / ``tv2d_data``) to isolate the iteration."""

import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from admm_tpu import ADMMConfig as JaxConfig
from admm_tpu import totalvariation as jax_tv
from admm_tpu.engine import Hooks as JaxHooks
from admm_tpu.engine import admm as jax_admm
from admm_tpu.linop import DiffOp as JaxDiffOp
from admm_tpu.ops.tridiag import CyclicReductionSolver as JaxCR
from admm_tpu.ops.tridiag import PackedCyclicReductionSolver
from admm_tpu_torch import ADMMConfig, Hooks, admm, totalvariation, totalvariation2d
from admm_tpu_torch.convert import numpy_state, tv2d_data, tv_data
from admm_tpu_torch.linop import DiffOp

torch.set_num_threads(1)
# The packages export solver functions under their modules' names.
jax_tv_mod = importlib.import_module("admm_tpu.models.totalvariation")
jax_tv2d_mod = importlib.import_module("admm_tpu.models.totalvariation2d")
tv_mod = importlib.import_module("admm_tpu_torch.models.totalvariation")
tv2d_mod = importlib.import_module("admm_tpu_torch.models.totalvariation2d")

HIST = ("pnorm", "dnorm", "perr", "derr", "objvals")


def _staircase(n, seed=5, step=30, noise=0.3):
    # tests/test_tridiag.py::test_tv_cr_variants_agree's signal.
    rng = np.random.default_rng(seed)
    return np.repeat(rng.standard_normal(-(-n // step)), step)[:n] + noise * rng.standard_normal(n)


def _blocky(m, n, seed=3):
    rng = np.random.default_rng(seed)
    truth = np.ones((m, n))
    truth[m // 4: 3 * m // 4, n // 3: 5 * n // 6] = 4.0
    return truth + rng.standard_normal((m, n))


def _assert_same_run(res, jres, rtol=1e-9):
    assert res.steps == jres.steps
    for name in ("xopt", "zopt", "uopt"):
        ref = np.asarray(getattr(jres, name))
        np.testing.assert_allclose(getattr(res, name).numpy(), ref, rtol=rtol,
                                   atol=rtol * np.max(np.abs(ref)))
    for name in HIST:
        if name in jres.hist:
            ref = jres.trace(name)
            np.testing.assert_allclose(res.trace(name), ref, rtol=rtol,
                                       atol=rtol * np.max(np.abs(ref)))


@pytest.mark.parametrize("n", [1, 2, 17])
def test_diffop_matches_jax(n):
    v = np.random.default_rng(n).standard_normal(n)
    op, jop = DiffOp(n), JaxDiffOp(n)
    np.testing.assert_array_equal(op.dense().numpy(), np.asarray(jop.dense(jnp.float64)))
    assert op.dense(torch.float32).dtype == torch.float32
    for fn in ("mv", "rmv"):
        np.testing.assert_array_equal(getattr(op, fn)(torch.from_numpy(v)).numpy(),
                                      np.asarray(getattr(jop, fn)(jnp.asarray(v))))
    np.testing.assert_allclose(op.rmv(torch.from_numpy(v)).numpy(),
                               op.dense().numpy().T @ v, atol=1e-12)
    assert op.out_shape((n,)) == (n,) and repr(op) == f"DiffOp({n})"


@pytest.mark.parametrize("solver,kw", [
    ("dense", {}),
    ("cr", {}),
    ("cr_masked", {}),
    ("cr", {"relax": 1.5}),
    ("dense", {"relax": 1.5}),
])
def test_totalvariation_matches_jax_f64(solver, kw):
    sig = _staircase(300)
    cfg = dict(maxiters=2000, objevals=True, **kw)
    jres = jax_tv(sig, 0.8, JaxConfig(**cfg), solver=solver)
    res = totalvariation(sig, 0.8, ADMMConfig(**cfg), solver=solver, device="cpu")
    assert res.steps < 2000
    assert res.xopt.dtype == torch.float64 and res.xopt.device.type == "cpu"
    _assert_same_run(res, jres)
    np.testing.assert_allclose(res.objopt, jres.objopt, rtol=1e-10)


def test_totalvariation_auto_picks_cr_above_2048():
    sig = _staircase(2100, seed=7, step=64, noise=0.5)
    cfg = dict(maxiters=300, domaxiters=True, unroll="auto")
    jres = jax_tv(sig, 0.5, JaxConfig(**cfg))
    res = totalvariation(sig, 0.5, ADMMConfig(**cfg), device="cpu")
    # 'auto' -> 'cr' takes the balanced unroll, 'dense' the GEMV one.
    assert res.config.unroll == jres.config.unroll == 4
    dense = totalvariation(sig[:2048], 0.5, ADMMConfig(maxiters=2, unroll="auto"),
                           device="cpu")
    assert dense.config.unroll == 16
    _assert_same_run(res, jres)


@pytest.mark.parametrize("n,solver,tail", [
    (2049, "cr", False),
    (16384, "cr", False),
    (16385, "cr", True),
    (16385, "cr_masked", False),
])
def test_hybrid_tail_gate_matches_jax(n, solver, tail):
    s = np.zeros(n)
    cfg = ADMMConfig()
    *_, data, _ = tv_mod.make_prox_ops(torch.from_numpy(s), 0.5, cfg, solver)
    *_, jdata, _ = jax_tv_mod.make_prox_ops(s, 0.5, JaxConfig(), solver)
    assert (data["cr"].Tinv is not None) == (jdata["cr"].Tinv is not None) == tail
    assert data["cr"].cut_stride == jdata["cr"].cut_stride


def _jax_state(sig, lam, cfg, solver, cutoff=None):
    """admm_tpu's TV setup for ``solver``; with ``cutoff`` its solver is
    swapped for the hybrid form at that cutoff (the production gate only
    takes it for n > 16384)."""
    pf, pg, obj, jdata, D = jax_tv_mod.make_prox_ops(sig, lam, cfg, solver)
    if cutoff is not None:
        n = sig.shape[0]
        diag = 1.0 + cfg.rho * np.r_[1.0, 2.0 * np.ones(n - 1)]
        off = -cfg.rho * np.ones(n)
        jdata["cr"] = JaxCR.from_tridiag(np.r_[0.0, off[1:]], diag, np.r_[off[:-1], 0.0],
                                         dense_cutoff=cutoff)
    return pf, pg, obj, jdata, D


@pytest.mark.parametrize("solver,cutoff", [("dense", None), ("cr", None), ("cr", 63)])
def test_totalvariation_iteration_on_carried_state(solver, cutoff):
    sig = _staircase(300, seed=8)
    n, lam = sig.shape[0], 0.8
    cfg = dict(maxiters=2000, objevals=True, unroll=3)
    jcfg = JaxConfig(**cfg)
    pf, pg, obj, jdata, D = _jax_state(sig, lam, jcfg, solver, cutoff)
    jres = jax_admm(pf, pg, jcfg, A=D, B=-1.0, c=0.0, m=n, nA=n, nB=n,
                    hooks=JaxHooks(obj=obj), dtype=jnp.float64, data=jdata)

    state = numpy_state(jdata)
    assert ("cr.Tinv" in state) == (cutoff is not None)
    data, warm = tv_data(state)
    assert warm == {} and isinstance(data["D"], DiffOp)
    back = numpy_state(data)
    assert set(back) == set(state)
    for key in state:
        np.testing.assert_array_equal(back[key], state[key])
    prox_f = tv_mod._prox_f_static if solver == "dense" else tv_mod._prox_f_cr
    res = admm(prox_f, tv_mod._prox_g, ADMMConfig(**cfg), A=data["D"], B=-1.0, c=0.0,
               m=n, nA=n, nB=n, hooks=Hooks(obj=tv_mod._obj), dtype=torch.float64,
               data=data)
    assert res.steps < 2000
    # The same operands on both sides: only elementwise rounding and the
    # dense products' summation order differ.
    _assert_same_run(res, jres, rtol=1e-12)


def test_tv_data_takes_a_device_dtype_and_warm_start():
    sig = _staircase(100)
    *_, jdata, _ = jax_tv_mod.make_prox_ops(sig, 0.8, JaxConfig(), "cr")
    x0 = np.ones(100)
    data, warm = tv_data(numpy_state(jdata, x0=x0), dtype=torch.float32)
    assert data["cr"].alphas.dtype == data["s"].dtype == warm["x0"].dtype == torch.float32
    assert data["cr"].masks_f.dtype == torch.bool
    x = data["cr"].solve(data["s"])
    assert x.dtype == torch.float32 and x.shape == (100,)


def test_convert_refuses_the_packed_solver():
    sig = _staircase(64)
    *_, jdata, _ = jax_tv_mod.make_prox_ops(sig, 0.8, JaxConfig(), "cr_packed")
    assert isinstance(jdata["cr"], PackedCyclicReductionSolver)
    with pytest.raises(ValueError, match="PackedCyclicReductionSolver"):
        numpy_state(jdata)


def test_tv_cr_variants_agree():
    """tests/test_tridiag.py::test_tv_cr_variants_agree: 'cr_packed',
    'cr_masked' and the dense path take the same trajectory (equal steps,
    xopt within 1e-9 of the masked run and 1e-6 of the dense one), and
    'cr_packed' against admm_tpu's 'cr_packed' (equal steps, 1e-10)."""
    sig = _staircase(300)
    cfg = ADMMConfig(maxiters=400)
    r_p = totalvariation(sig, 0.8, cfg, solver="cr_packed", device="cpu")
    r_m = totalvariation(sig, 0.8, cfg, solver="cr_masked", device="cpu")
    r_d = totalvariation(sig, 0.8, cfg, solver="dense", device="cpu")
    assert r_p.steps == r_m.steps
    np.testing.assert_allclose(r_p.xopt.numpy(), r_m.xopt.numpy(), rtol=1e-9, atol=1e-11)
    np.testing.assert_allclose(r_p.xopt.numpy(), r_d.xopt.numpy(), rtol=1e-6, atol=1e-8)
    jres = jax_tv(sig, 0.8, JaxConfig(maxiters=400), solver="cr_packed")
    assert r_p.steps == int(jres.steps)
    np.testing.assert_allclose(r_p.xopt.numpy(), np.asarray(jres.xopt), rtol=1e-10,
                               atol=1e-12)
    assert isinstance(tv_mod.make_prox_ops(torch.from_numpy(sig), 0.8, cfg, "cr_packed")[3]["cr"],
                      tv_mod.PackedCyclicReductionSolver)


@pytest.mark.parametrize("kw,exc,match", [
    (dict(solver="cr_packed", adaptive=True), ValueError, "static rho"),
    (dict(solver="cr", adaptive=True), ValueError, "static rho"),
    (dict(solver="cr_masked", rbadaptive=True), ValueError, "static rho"),
    (dict(adaptive=True), NotImplementedError, "slice 2"),
    (dict(solver="bogus"), ValueError, "unknown TV solver"),
    (dict(solver="dense", _plain_cr=True), ValueError, "cyclic-reduction"),
])
def test_unported_tv_modes_raise(kw, exc, match):
    """The refusals that stay ('cr_packed', which raised until slice 10c,
    runs: test_tv_cr_variants_agree; it keeps the reference's refusal of
    dynamic rho).  Adaptive TV, which raised until slice 2,
    now takes the dense eigenbasis x-update and is held against
    admm_tpu's adaptive TV, with and without the convtest monitor that
    lets rho move."""
    if match != "slice 2":
        with pytest.raises(exc, match=match):
            totalvariation(_staircase(64), 0.5, device="cpu", **kw)
        return
    sig = _staircase(64)
    for extra in ({}, {"convtest": True, "stopcond": "both"}):
        cfg = dict(maxiters=500, objevals=True, **kw, **extra)
        jres = jax_tv(sig, 0.5, JaxConfig(**cfg))
        res = totalvariation(sig, 0.5, ADMMConfig(**cfg), device="cpu")
        assert res.diverged == bool(jres.diverged)
        np.testing.assert_allclose(res.rho_final, float(jres.rho_final), rtol=1e-12)
        _assert_same_run(res, jres)


def test_totalvariation_demo_mode_raises():
    # The zero-argument demo runs its tester on the card by default; where
    # no card is visible it raises the placement error that names
    # device="cpu" (the CPU demo: tests/test_torch_demo_mode.py).
    if torch.cuda.is_available():
        assert totalvariation().steps > 0
        return
    with pytest.raises(RuntimeError, match='device="cpu"'):
        totalvariation()


def test_plain_cr_argument_runs_the_same_iteration():
    sig = _staircase(300, seed=9)
    cfg = ADMMConfig(maxiters=2000)
    a = totalvariation(sig, 0.8, cfg, solver="cr", device="cpu")
    b = totalvariation(sig, 0.8, cfg, solver="cr", device="cpu", _plain_cr=True)
    assert a.steps == b.steps
    assert torch.equal(a.xopt, b.xopt)


def test_totalvariation_f32_on_tensors():
    sig = torch.from_numpy(_staircase(3000, seed=2, step=64, noise=0.5).astype(np.float32))
    res = totalvariation(sig, 0.5, ADMMConfig(maxiters=2000))
    ref = totalvariation(sig.double(), 0.5, ADMMConfig(maxiters=2000))
    assert res.xopt.dtype == torch.float32 and res.xopt.device == sig.device
    assert abs(res.steps - ref.steps) <= 1
    scale = float(torch.max(torch.abs(ref.xopt)))
    np.testing.assert_allclose(res.xopt.numpy(), ref.xopt.numpy(), rtol=0,
                               atol=1e-4 * scale)


@pytest.mark.parametrize("kw", [{}, {"relax": 1.5}])
def test_totalvariation2d_matches_jax_f64(kw):
    S = _blocky(24, 20)
    cfg = dict(maxiters=2000, objevals=True, **kw)
    jres = jax_tv2d_mod.totalvariation2d(S, 1.0, JaxConfig(**cfg))
    res = totalvariation2d(S, 1.0, ADMMConfig(**cfg), device="cpu")
    assert res.steps < 2000 and res.xopt.shape == (24, 20) and res.zopt.shape == (2, 24, 20)
    _assert_same_run(res, jres)


def test_totalvariation2d_iteration_on_carried_state():
    S = _blocky(16, 12, seed=4)
    cfg = dict(maxiters=2000, unroll=5)
    jcfg = JaxConfig(**cfg)
    pf, pg, obj, jdata, A = jax_tv2d_mod.make_prox_ops(S, 0.7, jcfg)
    jres = jax_admm(pf, pg, jcfg, A=A, B=-1.0, c=0.0, shape_x=S.shape,
                    shape_z=(2,) + S.shape, hooks=JaxHooks(obj=obj),
                    dtype=jnp.float64, data=jdata)
    data, _ = tv2d_data(numpy_state(jdata))
    assert isinstance(data["A"], tv2d_mod.TV2DOp)
    res = admm(tv2d_mod._prox_f, tv2d_mod._prox_g, ADMMConfig(**cfg), A=data["A"],
               B=-1.0, c=0.0, shape_x=S.shape, shape_z=(2,) + S.shape,
               hooks=Hooks(obj=tv2d_mod._obj), dtype=torch.float64, data=data)
    _assert_same_run(res, jres, rtol=1e-12)


def test_tv2d_operator_and_stencil_match_jax():
    rng = np.random.default_rng(0)
    m, n = 13, 17
    X, V = rng.standard_normal((m, n)), rng.standard_normal((2, m, n))
    op, jop = tv2d_mod.TV2DOp(m, n), jax_tv2d_mod.TV2DOp(m, n)
    np.testing.assert_array_equal(op.mv(torch.from_numpy(X)).numpy(),
                                  np.asarray(jop.mv(jnp.asarray(X))))
    np.testing.assert_array_equal(op.rmv(torch.from_numpy(V)).numpy(),
                                  np.asarray(jop.rmv(jnp.asarray(V))))
    np.testing.assert_array_equal(tv2d_mod._dense_1d(9, torch.float64).numpy(),
                                  np.asarray(jax_tv2d_mod._dense_1d(9, jnp.float64)))
    assert op.out_shape((m, n)) == (2, m, n)


def test_chip_smoke_numpy_reference_counts_the_ports_steps():
    # chip_smoke.py holds the card's f32 step counts against this NumPy
    # f64 run of the same update sequence; on the CPU in f64 the two agree.
    import chip_smoke

    sig = chip_smoke.staircase(4096)
    cfg = ADMMConfig(maxiters=2000, unroll="auto")
    res = totalvariation(sig.astype(np.float64), 0.5, cfg, device="cpu")
    assert 10 < res.steps < 2000
    assert chip_smoke.numpy_tv_steps(sig, 0.5, cfg) == res.steps
