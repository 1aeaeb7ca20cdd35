"""The engine variants of the port (admm_tpu_torch/engine.py, slice 2)
against admm_tpu's engine in f64 on the model problem, with admm_tpu's
setup carried across by admm_tpu_torch/convert.py so that only the
iteration is compared.  The cases mirror tests/test_engine_features.py
and tests/test_rbadaptive.py case for case; every option is also held
bit for bit between unroll K and K = 1, and lasso's fused hook is shown to
leave K1b (``fused_zu_tail``) for every option it does not compute.

Bars: equal steps, ``diverged`` and ``stalled``; ``rho_final`` to rtol
1e-12; iterates to rtol 1e-9 and atol 1e-10; every trace to atol 1e-8 of
its first value (of its largest where the first is 0); ``restarted``
equal.
"""

import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from admm_tpu import ADMMConfig as JaxConfig
from admm_tpu import lasso as jax_lasso
from admm_tpu.engine import Hooks as JaxHooks
from admm_tpu.engine import admm as jax_admm
from admm_tpu.models.model import make_prox_ops as jax_model_ops
from admm_tpu.models.model import model as jax_model
from admm_tpu_torch import ADMMConfig, Hooks, admm, lasso, model
from admm_tpu_torch.convert import model_data, numpy_state

torch.set_num_threads(1)
model_mod = importlib.import_module("admm_tpu_torch.models.model")
engine_mod = importlib.import_module("admm_tpu_torch.engine")


def _instance(seed=7, m=64, n=48):
    # tests/test_engine_features.py's generator.
    rng = np.random.default_rng(seed)
    P, Q = rng.standard_normal((m, n)), rng.standard_normal((m, n))
    r, s = rng.standard_normal(m), rng.standard_normal(m)
    truex = np.linalg.solve(P.T @ P + Q.T @ Q, P.T @ r + Q.T @ s)
    return P, Q, r, s, truex


def _solve_both(cfg_kw, inst=None, wrap=None, hooks=None, jax_hooks=None, reference=True):
    """The model problem through admm_tpu's engine and, on its carried
    setup, through the port's: (port result, admm_tpu result, None without
    ``reference``).  ``wrap`` maps each prox (f, g) to the one solved (a
    fault injection); ``hooks``/``jax_hooks`` add hooks to each side
    (``jax_hooks`` defaults to ``hooks``)."""
    P, Q, r, s, _ = inst or _instance()
    n = P.shape[1]
    wrap = wrap or (lambda f, g: (f, g))
    jcfg = JaxConfig(**cfg_kw)
    jpf, jpg, jobj, jdata = jax_model_ops(P, Q, r, s, jcfg)
    jres = jax_admm(*wrap(jpf, jpg), jcfg, A=1.0, B=-1.0, c=0.0, m=n, nA=n, nB=n,
                    hooks=JaxHooks(obj=jobj, **(jax_hooks or hooks or {})),
                    dtype=jnp.float64, data=jdata) if reference else None
    data, _ = model_data(numpy_state(jdata), device="cpu")
    pf, pg = (getattr(model_mod, fn.__name__) for fn in (jpf, jpg))
    res = admm(*wrap(pf, pg), ADMMConfig(**cfg_kw), A=1.0, B=-1.0, c=0.0, m=n, nA=n, nB=n,
               hooks=Hooks(obj=model_mod._obj, **(hooks or {})), dtype=torch.float64,
               data=data)
    return res, jres


def _assert_match(res, jres):
    assert res.steps == jres.steps
    assert res.diverged == bool(jres.diverged)
    assert res.stalled == bool(jres.stalled)
    np.testing.assert_allclose(res.rho_final, float(jres.rho_final), rtol=1e-12)
    for name in ("xopt", "zopt", "uopt"):
        np.testing.assert_allclose(getattr(res, name).numpy(),
                                   np.asarray(getattr(jres, name)), rtol=1e-9, atol=1e-10)
    assert set(res.hist) == set(jres.hist)
    for name in jres.hist:
        ref = jres.trace(name)
        if name == "restarted":
            assert res.hist[name].dtype == torch.int32
            np.testing.assert_array_equal(res.trace(name), ref)
            continue
        scale = np.max(np.abs(ref[0])) or np.nanmax(np.abs(ref))
        np.testing.assert_allclose(res.trace(name), ref, rtol=0, atol=1e-8 * scale)


def _assert_identical(a, b):
    """Bit for bit (NaN where the other has NaN): steps, flags, rho,
    iterates, and the whole (N,) trace buffers (past ``steps`` too)."""
    assert (a.steps, a.diverged, a.stalled, a.rho_final) == (
        b.steps, b.diverged, b.stalled, b.rho_final)
    for name in ("xopt", "zopt", "uopt"):
        np.testing.assert_array_equal(getattr(a, name).numpy(), getattr(b, name).numpy())
    assert set(a.hist) == set(b.hist)
    for name in a.hist:
        np.testing.assert_array_equal(a.hist[name].numpy(), b.hist[name].numpy())


# ---- test_engine_features.py ------------------------------------------


@pytest.mark.parametrize("kw", [
    dict(fast=True, fasttype="strong"),
    dict(fast=True, fasttype="weak"),
    dict(relax=1.5),
    dict(relax=0.8),
    dict(stopcond="hnorm"),
])
def test_variants_converge(kw):
    # The accelerated run ignores the step cap's stop and reaches the f64
    # noise floor near step 320, where its restarts follow rounding: the
    # parity run stops at 300, the converged run is the port's own.
    res, jres = _solve_both(dict(maxiters=300, **kw))
    _assert_match(res, jres)
    *_, truex = _instance()
    full = model(*_instance()[:4], ADMMConfig(maxiters=5000, **kw), device="cpu")
    assert not full.diverged
    assert np.linalg.norm(full.xopt.numpy() - truex) < 1e-2


def test_accelerated_records_dvals_and_restarts():
    res, jres = _solve_both(dict(maxiters=300, fast=True, fasttype="weak"))
    _assert_match(res, jres)
    assert res.dvals is not None and len(res.dvals) == res.steps
    assert res.restarted is not None and res.restarted.sum() > 0
    assert "avals" in res.hist and res.Hnormsq is None


def test_record_iterates_traces():
    cfg = dict(maxiters=50, domaxiters=True, record_iterates=True, fast=True,
               fasttype="strong")
    res, jres = _solve_both(cfg)
    _assert_match(res, jres)
    for key in ("xvals", "zvals", "uvals", "vvals", "uhatvals", "wvals"):
        assert res.hist[key].shape[0] == 50, key
    assert torch.isfinite(res.hist["xvals"]).all()


def test_domaxiters_runs_exactly_n():
    res, jres = _solve_both(dict(maxiters=37, domaxiters=True))
    _assert_match(res, jres)
    assert res.steps == 37


def test_divergence_monitor_catches_broken_prox():
    # A sign-flipped x-prox must trip the H-norm monitor (admm.m:686-703)
    # at the reference's step; the correct one must not.
    cfg = dict(convtest=True, maxiters=100)
    res, jres = _solve_both(cfg, wrap=lambda f, g: ((lambda *a: -f(*a)), g))
    _assert_match(res, jres)
    assert res.diverged and res.steps < 100
    ok, jok = _solve_both(cfg)
    _assert_match(ok, jok)
    assert not ok.diverged


def test_nanguard_aborts_on_nonfinite():
    res, jres = _solve_both(dict(maxiters=500),
                            wrap=lambda f, g: ((lambda *a: f(*a) / 0.0 * 0.0), g))
    assert res.diverged and res.steps <= 3
    assert res.steps == jres.steps and bool(jres.diverged)


def test_adaptive_rho_runs_and_changes_rho():
    res, jres = _solve_both(dict(adaptive=True, convtest=True, maxiters=500))
    _assert_match(res, jres)
    assert torch.isfinite(res.xopt).all()
    assert res.rho_final != 1.0


def _altu(u, Ax, Bz, c, d):
    return u + (Ax + Bz - c)  # the standard update, via the hook


def _specialnorms(x, z, u, rho, d):
    # Deliberately not the standard norms; plain arithmetic, so the same
    # function runs on jnp arrays and torch tensors.
    return 2.0 * ((x - z) ** 2).sum() ** 0.5, rho * (z ** 2).sum() ** 0.5


def test_altu_and_specialnorms_hooks():
    cfg = dict(maxiters=60, domaxiters=True)
    hooks = dict(altu=_altu, specialnorms=_specialnorms)
    res, jres = _solve_both(cfg, hooks=hooks)
    _assert_match(res, jres)
    base, _ = _solve_both(cfg, reference=False)
    # altu is the standard update, so the trajectory is the plain one bit
    # for bit; the recorded norms are the hook's.
    assert res.steps == base.steps == 60
    assert torch.equal(res.xopt, base.xopt)
    assert not np.allclose(res.pnorm, base.pnorm)
    np.testing.assert_allclose(
        res.pnorm[-1], 2.0 * np.linalg.norm(res.xopt.numpy() - res.zopt.numpy()), rtol=1e-12)


def test_wvals_trace():
    res, jres = _solve_both(dict(maxiters=500, record_iterates=True))
    _assert_match(res, jres)
    n = res.xopt.numel()
    w = res.wvals
    assert w is not None and w.shape == (res.steps, 3 * n)
    k = res.steps - 1
    expect = np.concatenate([res.trace("xvals")[k], res.trace("zvals")[k],
                             res.rho_final * res.trace("uvals")[k]])
    np.testing.assert_allclose(w[k], expect, rtol=1e-12)


@pytest.mark.parametrize("kw", [dict(), dict(fast=True, fasttype="weak"), dict(relax=1.5),
                                dict(stopcond="both", convtest=True)])
def test_unroll_is_exact(kw):
    # unroll=K reproduces unroll=1 bit for bit, including N % K != 0 and a
    # stop inside a chunk; unroll=1 matches admm_tpu.
    maxiters = 300 if kw.get("fast") else 1001
    base, jres = _solve_both(dict(maxiters=maxiters, **kw))
    _assert_match(base, jres)
    for K in (3, 8):
        res, _ = _solve_both(dict(maxiters=maxiters, unroll=K, **kw), reference=False)
        _assert_identical(res, base)


def test_unroll_respects_maxiters_cap():
    res, jres = _solve_both(dict(maxiters=10, domaxiters=True, unroll=4))
    _assert_match(res, jres)
    assert res.steps == 10
    assert len(res.pnorm) == 10 and np.isfinite(res.pnorm).all()


def test_unroll_divergence_detection_exact():
    broken = lambda f, g: (f, (lambda *a: -g(*a)))  # sign error (convergencechecking.m)
    r1, j1 = _solve_both(dict(maxiters=200, convtest=True), wrap=broken)
    rK, jK = _solve_both(dict(maxiters=200, convtest=True, unroll=4), wrap=broken)
    _assert_match(r1, j1)
    _assert_match(rK, jK)
    assert r1.diverged and rK.diverged
    _assert_identical(rK, r1)


def test_preprocess_hook_receives_data():
    seen = {}

    def pre(d):
        seen["keys"] = sorted(d)

    def pf(x, z, u, rho, d):
        return d["t"] * (z - u)

    def pg(x, z, u, rho, d):
        return x + u

    res = admm(pf, pg, ADMMConfig(maxiters=5, domaxiters=True), A=1.0, B=-1.0, c=0.0,
               m=4, nA=4, nB=4, hooks=Hooks(preprocess=pre),
               data={"t": torch.tensor(0.5, dtype=torch.float64)})
    assert seen["keys"] == ["t"]
    assert res.steps == 5
    # Without data the hook takes no argument.
    calls = []
    admm(lambda x, z, u, rho: z - u, lambda x, z, u, rho: x + u,
         ADMMConfig(maxiters=2), m=4, device="cpu", hooks=Hooks(preprocess=lambda: calls.append(1)))
    assert calls == [1]


# ---- the stall detector (ADMMConfig.stallwindow) ------------------------


def _plateau_f(x, z, u, rho, d):
    return d["a"] + 0.0 * z  # x never moves ...


def _plateau_g(x, z, u, rho, d):
    return d["b"] + 0.0 * x  # ... nor z: pnorm = ||a - b|| every step


def _plateau(cfg_kw, nan=False):
    """A run whose primal residual is a plateau by construction (constant
    x and z; a NaN one with ``nan``), solved by both engines."""
    rng = np.random.default_rng(4)
    a, b = rng.standard_normal(16), rng.standard_normal(16)
    if nan:
        a[3] = np.nan
    jres = jax_admm(_plateau_f, _plateau_g, JaxConfig(**cfg_kw), m=16, dtype=jnp.float64,
                    data={"a": jnp.asarray(a), "b": jnp.asarray(b)})
    res = admm(_plateau_f, _plateau_g, ADMMConfig(**cfg_kw), m=16, dtype=torch.float64,
               data={"a": torch.from_numpy(a), "b": torch.from_numpy(b)})
    return res, jres


def _f32_stalling_model(seed=3):
    """The model problem in f32 with an f64-grade stop: the residual
    floors above the Boyd gate, so without the detector the solve burns
    its whole budget."""
    P, Q, r, s, truex = _instance(seed)
    return tuple(a.astype(np.float32) for a in (P, Q, r, s)) + (truex,)


def test_stall_detector_stops_plateaued_f32_run():
    res, jres = _plateau(dict(maxiters=400, stallwindow=60))
    _assert_match(res, jres)
    assert res.stalled and not res.diverged and res.steps == 61
    P, Q, r, s, truex = _f32_stalling_model()
    kw = dict(maxiters=4000, abstol=1e-12, reltol=1e-11)
    burn = model(P, Q, r, s, ADMMConfig(**kw), device="cpu")
    assert burn.steps == 4000 and not burn.stalled  # the failure mode
    stall = model(P, Q, r, s, ADMMConfig(stallwindow=60, **kw), device="cpu")
    assert stall.stalled and not stall.diverged and stall.steps < 4000
    # Stopping at the plateau loses nothing: both sit at the f32 floor.
    err = lambda x: np.linalg.norm(x.double().numpy() - truex)
    assert err(stall.xopt) <= 2.0 * err(burn.xopt) + 1e-5


def test_stall_detector_inert_on_converging_run():
    base, _ = _solve_both(dict(maxiters=2000), reference=False)
    res, jres = _solve_both(dict(maxiters=2000, stallwindow=200))
    _assert_match(res, jres)
    assert not res.stalled and res.steps == base.steps
    assert torch.equal(res.xopt, base.xopt)


def test_stall_detector_unroll_exact():
    # A NaN plateau trips the window too (NaN never counts as progress,
    # not even on the first step), with nanguard off, at the same step for
    # every K.
    kw = dict(maxiters=300, stallwindow=50, nanguard=False)
    r1, j1 = _plateau(kw, nan=True)
    _assert_match(r1, j1)
    assert r1.stalled and r1.steps == 50
    rK, _ = _plateau(dict(kw, unroll=8), nan=True)
    _assert_identical(rK, r1)
    P, Q, r, s, _ = _f32_stalling_model(11)
    kw = dict(maxiters=3000, abstol=1e-12, reltol=1e-11, stallwindow=50)
    a = model(P, Q, r, s, ADMMConfig(unroll=1, **kw), device="cpu")
    b = model(P, Q, r, s, ADMMConfig(unroll=8, **kw), device="cpu")
    assert a.stalled and b.stalled
    _assert_identical(b, a)


def test_stall_config_validation_and_domaxiters_gate():
    with pytest.raises(ValueError, match="stallwindow"):
        ADMMConfig(stallwindow=-1)
    with pytest.raises(ValueError, match="stalltol"):
        ADMMConfig(stalltol=1.5)
    assert not ADMMConfig(stallwindow=50, domaxiters=True).use_stall
    assert ADMMConfig(stallwindow=50).use_stall
    res, jres = _plateau(dict(maxiters=300, domaxiters=True, stallwindow=20))
    _assert_match(res, jres)
    assert res.steps == 300 and not res.stalled


def test_quiet_false_prints_table_rows(capfd):
    # One row per executed step plus the summary line, only live steps of
    # each chunk, in admm_tpu's format and with its values.
    P, Q, r, s, _ = _instance()
    jres = jax_model(P, Q, r, s, JaxConfig(maxiters=500, quiet=False, unroll=4))
    import jax

    jax.effects_barrier()
    jout = capfd.readouterr().out
    res = model(P, Q, r, s, ADMMConfig(maxiters=500, quiet=False, unroll=4), device="cpu")
    out = capfd.readouterr().out
    rows = [ln for ln in out.splitlines() if "pnorm" in ln and "perr" in ln]
    jrows = [ln for ln in jout.splitlines() if "pnorm" in ln and "perr" in ln]
    assert len(rows) == res.steps == jres.steps
    assert rows[0].startswith("1\t") and rows[-1].startswith(f"{res.steps}\t")
    assert f"ADMM finished: {res.steps} steps" in out
    assert rows == jrows


# ---- test_rbadaptive.py -----------------------------------------------


def test_rb_recovers_from_bad_rho():
    inst = _instance(0, 96, 64)
    bad = dict(rho=1e-4, maxiters=20000)
    rb, jrb = _solve_both(dict(bad, rbadaptive=True), inst=inst)
    _assert_match(rb, jrb)
    fixed = model(*inst[:4], ADMMConfig(**bad), device="cpu")
    assert np.linalg.norm(rb.xopt.numpy() - inst[4]) < 1e-2
    assert rb.steps < fixed.steps / 3
    assert rb.rho_final != pytest.approx(1e-4)


def _rb_lasso_instance():
    rng = np.random.default_rng(1)
    D = rng.standard_normal((256, 64))
    D = D / np.sqrt(np.sum(D**2, axis=0, keepdims=True))
    tx = rng.standard_normal(64) * (rng.random(64) < 0.5)
    s = D @ tx + 0.03 * rng.standard_normal(256)
    return D, s, 0.1 * np.max(np.abs(D.T @ s))


def test_rb_matches_fixed_solution_quality():
    D, s, lam = _rb_lasso_instance()

    def obj(x):
        return 0.5 * np.sum((D @ x - s) ** 2) + lam * np.sum(np.abs(x))

    fixed = lasso(D, s, lam, ADMMConfig(maxiters=5000), device="cpu")
    rb = lasso(D, s, lam, ADMMConfig(maxiters=5000, rbadaptive=True), device="cpu")
    f_fixed, f_rb = obj(fixed.xopt.numpy()), obj(rb.xopt.numpy())
    assert abs(f_rb - f_fixed) <= 1e-3 * abs(f_fixed) + 1e-9
    jrb = jax_lasso(D, s, lam, JaxConfig(maxiters=5000, rbadaptive=True))
    assert rb.steps == jrb.steps
    np.testing.assert_allclose(rb.rho_final, float(jrb.rho_final), rtol=1e-12)
    np.testing.assert_allclose(rb.xopt.numpy(), np.asarray(jrb.xopt), rtol=1e-9, atol=1e-10)


def test_rb_unroll_exact_and_rescales_u():
    # The scaled-dual rescale u / factor lands before the records: the
    # recorded w carries rho_new * u, which is rho * u before the rescale.
    cfg = dict(rho=1e-2, maxiters=400, rbadaptive=True, record_iterates=True)
    base, jres = _solve_both(cfg)
    _assert_match(base, jres)
    res, _ = _solve_both(dict(cfg, unroll=5), reference=False)
    _assert_identical(res, base)
    k = base.steps - 1
    n = base.xopt.numel()
    np.testing.assert_allclose(base.wvals[k, 2 * n:], base.rho_final * base.trace("uvals")[k],
                               rtol=1e-12)


def test_rb_config_validation():
    for kw in (dict(rbadaptive=True, nodualerror=True), dict(rbadaptive=True, adaptive=True),
               dict(rbadaptive=True, fast=True)):
        with pytest.raises(ValueError):
            ADMMConfig(**kw)


# ---- every option: K equal to K = 1, and where K1b is not taken --------

OPTIONS = {
    "fast_weak": dict(fast=True),
    "fast_strong": dict(fast=True, fasttype="strong"),
    "hnorm": dict(stopcond="hnorm"),
    "both_convtest": dict(stopcond="both", convtest=True),
    "adaptive": dict(adaptive=True, convtest=True),
    "rbadaptive": dict(rbadaptive=True, rho=0.05),
    "stallwindow": dict(stallwindow=7),
    "anderson": dict(anderson=4),
    "record_iterates": dict(record_iterates=True),
    "objevals_quiet": dict(objevals=True, quiet=False),
}


@pytest.mark.parametrize("name", list(OPTIONS))
def test_every_option_unroll_equals_k1(name, capsys):
    cfg = dict(maxiters=97, **OPTIONS[name])
    base, _ = _solve_both(cfg, reference=False)
    for K in (4, 7):
        res, _ = _solve_both(dict(cfg, unroll=K), reference=False)
        _assert_identical(res, base)


def _lasso_instance(seed=2, rows=64, cols=128):
    rng = np.random.default_rng(seed)
    D = rng.standard_normal((rows, cols))
    D = D / np.sqrt(np.sum(D**2, axis=0, keepdims=True))
    s = D @ (rng.standard_normal(cols) * (rng.random(cols) < 0.6))
    return D, s + np.sqrt(0.001) * rng.standard_normal(rows), 0.1 * np.max(np.abs(D.T @ s))


_NOT_IN_K1B = {
    "rbadaptive": (dict(rbadaptive=True), {}),
    "adaptive": (dict(adaptive=True, convtest=True), {}),
    "adaptive_alone": (dict(adaptive=True), {}),
    "stopcond_hnorm": (dict(stopcond="hnorm"), {}),
    "stopcond_both": (dict(stopcond="both"), {}),
    "convtest": (dict(convtest=True), {}),
    "stallwindow": (dict(stallwindow=10), {}),
    "anderson": (dict(anderson=5), {}),
    "record_iterates": (dict(record_iterates=True), {}),
    "specialnorms": ({}, dict(specialnorms=_specialnorms)),
}


@pytest.mark.parametrize("name", list(_NOT_IN_K1B))
def test_fused_hook_leaves_k1b_for_options_it_does_not_compute(name, monkeypatch):
    """lasso's fused hook is marked for K1b, whose tail knows no rho
    update, u rescale, H-norm, stall window, Anderson window, iterate
    record or special norms.  Under each, the step is prox_f, the hook's
    z/u pass and the generic tail, and matches admm_tpu's fused run."""
    calls = []
    real = engine_mod.fused_zu_tail
    monkeypatch.setattr(engine_mod, "fused_zu_tail",
                        lambda *a, **k: (calls.append(1), real(*a, **k))[1])
    kw, hooks = _NOT_IN_K1B[name]
    D, s, lam = _lasso_instance()
    cfg = dict(maxiters=150, unroll=4, **kw)
    if hooks:
        lasso_mod = importlib.import_module("admm_tpu_torch.models.lasso")
        jlasso_mod = importlib.import_module("admm_tpu.models.lasso")
        _, _, _, jdata = jlasso_mod.make_prox_ops(jnp.asarray(D), jnp.asarray(s), lam,
                                                  JaxConfig(**cfg))
        n = D.shape[1]
        jres = jax_admm(jlasso_mod._prox_f_fat_static, jlasso_mod._prox_g, JaxConfig(**cfg),
                        m=n, hooks=JaxHooks(fused_zu=jlasso_mod._fused_zu, **hooks),
                        dtype=jnp.float64, data=jdata)
        from admm_tpu_torch.convert import lasso_data

        data, _ = lasso_data(numpy_state(jdata))
        res = admm(lasso_mod._prox_f_fat_static, lasso_mod._prox_g, ADMMConfig(**cfg), m=n,
                   hooks=Hooks(fused_zu=lasso_mod._fused_zu, **hooks), dtype=torch.float64,
                   data=data)
    else:
        jres = jax_lasso(D, s, lam, JaxConfig(**cfg), use_fused_kernel=True)
        res = lasso(D, s, lam, ADMMConfig(**cfg), use_fused_kernel=True, device="cpu")
    assert calls == []
    assert res.steps == jres.steps and res.stalled == bool(jres.stalled)
    np.testing.assert_allclose(res.rho_final, float(jres.rho_final), rtol=1e-12)
    np.testing.assert_allclose(res.xopt.numpy(), np.asarray(jres.xopt), rtol=1e-9, atol=1e-10)
    # The control: the plain standard stop, quiet=False and objevals keep K1b.
    lasso(D, s, lam, ADMMConfig(maxiters=8, objevals=True, quiet=False), use_fused_kernel=True,
          device="cpu")
    assert calls == [1] * 8


# ---- the shared helpers, against admm_tpu's -----------------------------


def _pair(*vals):
    """The same f64 values as jnp arrays and as torch tensors."""
    return ([jnp.asarray(v, jnp.float64) for v in vals],
            [torch.tensor(v, dtype=torch.float64) for v in vals])


@pytest.mark.parametrize("alg", [1, 2])
@pytest.mark.parametrize("restart", [False, True])
def test_fast_update_matches_jax(alg, restart):
    from admm_tpu.engine import fast_update as jax_fast_update
    from admm_tpu_torch.engine import fast_update

    rng = np.random.default_rng(alg + 2 * restart)
    z, zprev, u, uprev, v = (rng.standard_normal(6) for _ in range(5))
    aprev, dprev = 2.5, 0.7
    # dval below restart * dprev keeps the momentum; above it restarts.
    dval = 0.9 if restart else 0.3
    cfg = JaxConfig(fast=True, fasttype="strong" if alg == 1 else "weak")
    (jz, jzp, ju, jup, jv, ja, jd, jdv), (tz, tzp, tu, tup, tv, ta, td, tdv) = _pair(
        z, zprev, u, uprev, v, aprev, dprev, dval)
    ref = jax_fast_update(alg, cfg, aprev=ja, dprev=jd, z=jz, zprev=jzp, u=ju, uprev=jup,
                          v=jv, dval=jdv if alg == 2 else None)
    got = fast_update(alg, ADMMConfig(**vars(cfg)), aprev=ta, dprev=td, z=tz, zprev=tzp,
                      u=tu, uprev=tup, v=tv, dval=tdv if alg == 2 else None)
    for r, g in zip(ref, got):
        if isinstance(r, tuple):
            assert g is None
        else:
            np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=1e-15, atol=1e-15)
    if alg == 2:
        assert int(got[4]) == int(restart) and got[4].dtype == torch.int32


@pytest.mark.parametrize("Hprev,Hsq,i,done", [
    (4.0, 1.0, 5, False),      # H falls: rho grows by Hprev - Hsq's step
    (1.0, 1.2, 5, False),      # H rises: the reference's negative step
    (1.0, 1.0, 5, False),      # wdiff below eps: rho kept, then clamped
    (4.0, 1.0, 2, False),      # i <= 2: rho held
    (4.0, 1.0, 5, True),       # done: rho held
    (float("inf"), 1.0, 3, False),
])
def test_adaptive_rho_update_matches_jax(Hprev, Hsq, i, done):
    from admm_tpu.engine import adaptive_rho_update as jax_update
    from admm_tpu_torch.engine import adaptive_rho_update

    (jH, jS, jr), (tH, tS, tr) = _pair(Hprev, Hsq, 0.8)
    eps = float(np.finfo(np.float64).eps)
    ref = jax_update(JaxConfig(), Hprev=jH, Hsq=jS, rho=jr, i=jnp.asarray(i),
                     done=jnp.asarray(done), eps=eps)
    got = adaptive_rho_update(ADMMConfig(), Hprev=tH, Hsq=tS, rho=tr, i=torch.tensor(i),
                              done=torch.tensor(done), eps=eps)
    assert float(got) == float(ref)


@pytest.mark.parametrize("pnorm,dnorm,done", [
    (5.0, 0.1, False), (0.1, 5.0, False), (1.0, 1.0, False), (5.0, 0.1, True)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_residual_balance_factor_matches_jax(pnorm, dnorm, done, dtype):
    from admm_tpu.engine import residual_balance_factor as jax_factor
    from admm_tpu_torch.engine import residual_balance_factor

    jdt = jnp.float32 if dtype == torch.float32 else jnp.float64
    cfg = dict(rbadaptive=True, rbtau=3.0)
    ref = jax_factor(JaxConfig(**cfg), pnorm=jnp.asarray(pnorm, jdt),
                     dnorm=jnp.asarray(dnorm, jdt), done=jnp.asarray(done), dtype=jdt)
    got = residual_balance_factor(ADMMConfig(**cfg), pnorm=torch.tensor(pnorm, dtype=dtype),
                                  dnorm=torch.tensor(dnorm, dtype=dtype),
                                  done=torch.tensor(done), dtype=dtype)
    assert got.dtype == dtype and got.item() == float(ref)
