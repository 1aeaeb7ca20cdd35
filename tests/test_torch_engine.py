"""Parity of the port's engine (admm_tpu_torch/engine.py) against
admm_tpu's, in f64, on identical operands carried across by
admm_tpu_torch/convert.py (so the setup algebra is shared and only the
iteration is compared)."""

import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from admm_tpu import ADMMConfig as JaxConfig
from admm_tpu.engine import Hooks as JaxHooks
from admm_tpu.engine import admm as jax_admm
from admm_tpu_torch import ADMMConfig, Hooks, admm
from admm_tpu_torch.convert import lasso_data, numpy_state
from admm_tpu_torch.models.lasso import (_fused_zu, _obj, _prox_f_fat, _prox_f_fat_static,
                                         _prox_g)

torch.set_num_threads(1)
jax_lasso_mod = importlib.import_module("admm_tpu.models.lasso")

HIST = ("pnorm", "dnorm", "perr", "derr")


def _instance(seed=2, rows=64, cols=128, density=0.6):
    # tests/test_lasso.py's generator (planted sparse signal + noise).
    rng = np.random.default_rng(seed)
    testx = rng.standard_normal(cols) * (rng.random(cols) < density)
    D = rng.standard_normal((rows, cols))
    D = D / np.sqrt(np.sum(D**2, axis=0, keepdims=True))
    s = D @ testx + np.sqrt(0.001) * rng.standard_normal(rows)
    lam = 0.1 * np.max(np.abs(D.T @ s))
    return D, s, lam


def _jax_side(cfg_kw, fused=False, seed=2, hooks=None):
    """Build the fat LASSO operands with admm_tpu (the static or, under a
    dynamic-rho config, the Woodbury x-update), solve with its engine, and
    return (result, numpy state)."""
    D, s, lam = _instance(seed)
    n = D.shape[1]
    _, _, _, jdata = jax_lasso_mod.make_prox_ops(
        jnp.asarray(D), jnp.asarray(s), lam, JaxConfig(**cfg_kw))
    prox_f = "_prox_f_fat" if "wood" in jdata else "_prox_f_fat_static"
    hooks = JaxHooks(obj=jax_lasso_mod._obj,
                     fused_zu=jax_lasso_mod._fused_zu if fused else None, **(hooks or {}))
    res = jax_admm(getattr(jax_lasso_mod, prox_f), jax_lasso_mod._prox_g,
                   JaxConfig(**cfg_kw), A=1.0, B=-1.0, c=0.0, m=n, nA=n, nB=n,
                   hooks=hooks, dtype=jnp.float64, data=jdata)
    return res, numpy_state(jdata)


def _port(state, cfg_kw, fused=False, hooks=None, **kw):
    data, _ = lasso_data(state, device="cpu")
    n = data["D"].shape[1]
    prox_f = _prox_f_fat if "wood" in data else _prox_f_fat_static
    hooks = Hooks(obj=_obj, fused_zu=_fused_zu if fused else None, **(hooks or {}))
    return admm(prox_f, _prox_g, ADMMConfig(**cfg_kw),
                A=1.0, B=-1.0, c=0.0, m=n, nA=n, nB=n, hooks=hooks,
                dtype=torch.float64, data=data, **kw)


def _assert_match_jax(res, jres):
    # The bars of every parity case: equal steps and flags, rho to 1e-12,
    # iterates to rtol 1e-9 / atol 1e-10, every trace to 1e-8 of its first
    # value (of its largest where the first is 0: alg 1's first dnorm), the
    # int restart flags equal.
    assert res.steps == jres.steps
    assert res.diverged == bool(jres.diverged)
    assert res.stalled == bool(jres.stalled)
    np.testing.assert_allclose(res.rho_final, float(jres.rho_final), rtol=1e-12)
    for name in ("xopt", "zopt", "uopt"):
        np.testing.assert_allclose(getattr(res, name).numpy(),
                                   np.asarray(getattr(jres, name)),
                                   rtol=1e-9, atol=1e-10)
    assert set(res.hist) == set(jres.hist)
    for name in jres.hist:
        ref = jres.trace(name)
        if name == "restarted":
            np.testing.assert_array_equal(res.trace(name), ref)
            continue
        scale = np.max(np.abs(ref[0])) or np.nanmax(np.abs(ref))
        np.testing.assert_allclose(res.trace(name), ref, rtol=0, atol=1e-8 * scale)
    if res.objopt is not None:
        np.testing.assert_allclose(res.objopt, float(jres.objopt), rtol=1e-10)


def _assert_identical(a, b):
    assert a.steps == b.steps
    for name in ("xopt", "zopt", "uopt"):
        assert torch.equal(getattr(a, name), getattr(b, name))
    for name in a.hist:
        # Whole (N,) buffers: NaN past steps must match too.
        np.testing.assert_array_equal(a.hist[name].numpy(), b.hist[name].numpy())


@pytest.mark.parametrize("fused", [False, True])
@pytest.mark.parametrize("domaxiters", [False, True])
def test_unroll_chunks_equal_k1_and_match_jax(domaxiters, fused):
    # N = 47 is not a multiple of any K below, so the last chunk holds
    # frozen sub-steps past k = N (admm_tpu engine.py:425-429); the
    # converging run stops inside a chunk for at least one K.
    cfg = dict(maxiters=47 if domaxiters else 2000, domaxiters=domaxiters,
               objevals=True)
    jres, state = _jax_side(dict(cfg, unroll=1), fused=fused)
    ref = _port(state, dict(cfg, unroll=1), fused=fused)
    _assert_match_jax(ref, jres)
    Ks = (3, 4, 5)
    if domaxiters:
        assert ref.steps == 47
    else:
        assert ref.steps < 2000 and any(ref.steps % K for K in Ks)
    for K in Ks:
        _assert_identical(_port(state, dict(cfg, unroll=K), fused=fused), ref)


@pytest.mark.parametrize("unroll", [1, 4])
def test_unroll_matches_jax_unroll(unroll):
    cfg = dict(maxiters=50, domaxiters=True, unroll=unroll)
    jres, state = _jax_side(cfg, fused=True)
    _assert_match_jax(_port(state, cfg, fused=True), jres)


@pytest.mark.parametrize("kw", [dict(relax=1.6), dict(nodualerror=True),
                                dict(nanguard=False)])
def test_engine_options_match_jax(kw):
    cfg = dict(maxiters=2000, **kw)
    jres, state = _jax_side(cfg)
    res = _port(state, cfg)
    _assert_match_jax(res, jres)
    if kw.get("nodualerror"):
        assert np.all(np.isnan(res.trace("dnorm")))


def test_relax_skips_the_fused_hook():
    # The fused pass applies only under relax == 1 (admm_tpu
    # engine.py:519-522): with relax != 1 the engine must take prox_g and
    # the standard dual update, exactly as without the hook.
    calls = []

    def counting_fused(x, u, rho, d):
        calls.append(1)
        return _fused_zu(x, u, rho, d)

    cfg = dict(maxiters=2000, relax=1.6)
    _, state = _jax_side(cfg)
    data, _ = lasso_data(state, device="cpu")
    n = data["D"].shape[1]
    with_hook = admm(_prox_f_fat_static, _prox_g, ADMMConfig(**cfg), m=n,
                     hooks=Hooks(fused_zu=counting_fused),
                     dtype=torch.float64, data=data)
    _assert_identical(with_hook, _port(state, cfg))
    assert not calls


def test_domaxiters_runs_all_steps():
    _, state = _jax_side(dict(maxiters=10))
    for K in (1, 7):
        res = _port(state, dict(maxiters=37, domaxiters=True, unroll=K))
        assert res.steps == 37
        assert not np.isnan(res.trace("pnorm")).any()


@pytest.mark.parametrize("unroll", [1, 3])
def test_nanguard_trips_on_nan_prox(unroll):
    n = 16

    def prox_f(x, z, u, rho):
        return x + float("nan")

    def prox_g(x, z, u, rho):
        return x

    res = admm(prox_f, prox_g, ADMMConfig(maxiters=100, unroll=unroll), m=n,
               dtype=torch.float64, device="cpu")
    jres = jax_admm(prox_f, prox_g, JaxConfig(maxiters=100, unroll=unroll),
                    m=n, dtype=jnp.float64)
    assert res.diverged and bool(jres.diverged)
    assert res.steps == jres.steps == 1
    off = admm(prox_f, prox_g, ADMMConfig(maxiters=20, nanguard=False), m=n,
               dtype=torch.float64, device="cpu")
    assert not off.diverged and off.steps == 20


@pytest.mark.parametrize("A,c,match", [
    (2.0, 0.0, "A=1, B=-1"),
    (1.0, 0.5, "c = 0"),
])
def test_fused_splitting_check(A, c, match):
    with pytest.raises(ValueError, match=match):
        admm(lambda *a: a[0], lambda *a: a[0], ADMMConfig(), A=A, c=c, m=8,
             hooks=Hooks(fused_zu=lambda x, u, rho: (x, u)), dtype=torch.float64,
             device="cpu")


def _altu(u, Ax, Bz, c, d):
    return u + (Ax + Bz - c)  # the standard dual update, through the hook


def _specialnorms(x, z, u, rho, d):
    # Deliberately not the standard norms; plain arithmetic, so the same
    # function runs on jnp arrays and torch tensors.
    return 2.0 * ((x - z) ** 2).sum() ** 0.5, rho * (z ** 2).sum() ** 0.5


_PREPROCESSED = []


def _preprocess(d):
    _PREPROCESSED.append(sorted(d))


@pytest.mark.parametrize("kw,hook,name", [
    (dict(fast=True), {}, "fast"),
    (dict(fast=True, fasttype="strong"), {}, "fast"),
    (dict(stopcond="hnorm"), {}, "stopcond"),
    (dict(stopcond="both"), {}, "stopcond"),
    (dict(convtest=True), {}, "convtest"),
    (dict(adaptive=True), {}, "adaptive"),
    (dict(rbadaptive=True), {}, "rbadaptive"),
    (dict(stallwindow=5), {}, "stallwindow"),
    (dict(anderson=3), {}, "anderson"),
    (dict(record_iterates=True), {}, "record_iterates"),
    ({}, dict(altu=_altu), "altu"),
    ({}, dict(specialnorms=_specialnorms), "specialnorms"),
    ({}, dict(preprocess=_preprocess), "preprocess"),
    ({}, "parallel", "parallel"),
])
def test_unported_options_raise(kw, hook, name):
    """Nothing raises any more.  Every option and hook of slice 2 solves
    the fat LASSO as admm_tpu's engine does, on carried state, to the
    parity bars; parallel= (slice 10a) runs a per-slice prox over the
    slices of a stacked 4-shard mesh as admm_tpu runs it over 4 CPU
    devices."""
    if hook == "parallel":
        import jax

        from admm_tpu.parallel import make_mesh as jax_mesh
        from admm_tpu_torch.parallel import make_mesh

        rng = np.random.default_rng(3)
        Mn = rng.standard_normal((8, 8)) / 8.0
        M, Mj = torch.as_tensor(Mn), jnp.asarray(Mn)
        cfg = dict(maxiters=50)
        jres = jax_admm(lambda x, z, u, rho, k: jax.lax.dynamic_slice_in_dim(Mj, 2 * k, 2)
                        @ (z - u), lambda x, z, u, rho: 0.5 * (x + u), JaxConfig(**cfg),
                        A=1.0, B=-1.0, c=0.0, m=8, dtype=jnp.float64, parallel="xminf",
                        slices=2, mesh=jax_mesh(4))
        res = admm(lambda x, z, u, rho, k: M[2 * k:2 * k + 2] @ (z - u),
                   lambda x, z, u, rho: 0.5 * (x + u), ADMMConfig(**cfg), A=1.0, B=-1.0,
                   c=0.0, m=8, dtype=torch.float64, device="cpu", parallel="xminf", slices=2,
                   mesh=make_mesh(4, device="cpu"))
        _assert_match_jax(res, jres)
        return
    # 150 steps: the accelerated run (whose d-value stop ignores the cap)
    # stays above the f64 noise floor, which it reaches near step 170 and
    # where its restarts would follow rounding.
    cfg = dict(maxiters=150, **kw)
    jres, state = _jax_side(cfg, hooks=hook)
    _PREPROCESSED.clear()
    res = _port(state, cfg, hooks=hook)
    _assert_match_jax(res, jres)
    assert res.steps > 5
    if name == "preprocess":
        assert _PREPROCESSED == [sorted(state_keys(state))]
    if name == "specialnorms":
        np.testing.assert_allclose(
            res.pnorm[-1], 2.0 * np.linalg.norm(res.xopt.numpy() - res.zopt.numpy()), rtol=1e-12)


def state_keys(state):
    """The data keys ``lasso_data`` rebuilds from a flat state."""
    return {key.partition(".")[0] for key in state}


def test_quiet_false_prints_summary_line(capsys):
    # quiet=False: one table row per step (admm_tpu's per-iteration rows),
    # then the summary line.
    _, state = _jax_side(dict(maxiters=10))
    res = _port(state, dict(maxiters=2000, quiet=False, unroll=4))
    out = capsys.readouterr().out.strip().splitlines()
    assert len(out) == res.steps + 1
    assert out[0].startswith("1\tpnorm ") and out[-2].startswith(f"{res.steps}\tpnorm ")
    assert out[-1].startswith(f"ADMM finished: {res.steps} steps")


def test_shapes_dtype_and_device_resolution():
    # dtype from x0, device from x0, shapes from x0/z0; c broadcast to A's
    # output shape; default u0 zeros of c's shape.
    x0 = torch.ones(5, dtype=torch.float32)
    res = admm(lambda x, z, u, rho: 0.5 * (z - u), lambda x, z, u, rho: x + u,
               ADMMConfig(maxiters=3, domaxiters=True), x0=x0, z0=np.zeros(5))
    assert res.xopt.dtype == torch.float32 and res.xopt.device == x0.device
    assert res.uopt.shape == (5,) and res.steps == 3
    with pytest.raises(ValueError, match="nA, shape_x, or x0"):
        admm(lambda *a: a[0], lambda *a: a[0], ADMMConfig(), device="cpu")


def _pf(x, z, u, rho, d):
    # f(x) = 1/2||x - a||^2 under A = 2I, B = -I: plain arithmetic, so the
    # same function runs on jnp arrays and torch tensors.
    return (d["a"] - 2.0 * rho * (-z - d["c"] + u)) / (1.0 + 4.0 * rho)


def _pg(axr, z, u, rho, d):
    # g(z) = 1/2||z - b||^2 with the (relaxed) A x as first argument.
    return (d["b"] + rho * (axr - d["c"] + u)) / (1.0 + rho)


@pytest.mark.parametrize("relax", [1.0, 1.5])
@pytest.mark.parametrize("dense", [False, True])
def test_general_splitting_matches_jax(dense, relax):
    # A = 2I (scalar or dense matrix), B = -I, c != 0: the generic path
    # with a nonzero c and a DenseOp (admm_tpu engine.py:600-661).
    rng = np.random.default_rng(7)
    n = 24
    a, b, c = (rng.standard_normal(n) for _ in range(3))
    A = 2.0 * np.eye(n) if dense else 2.0
    cfg = dict(maxiters=500, relax=relax, abstol=1e-9, reltol=1e-8)
    jdata = {"a": jnp.asarray(a), "b": jnp.asarray(b), "c": jnp.asarray(c)}
    tdata = {k: torch.from_numpy(v) for k, v in (("a", a), ("b", b), ("c", c))}
    jres = jax_admm(_pf, _pg, JaxConfig(**cfg), A=A, B=-1.0, c=c, nA=n, nB=n,
                    dtype=jnp.float64, data=jdata)
    res = admm(_pf, _pg, ADMMConfig(**cfg), A=A, B=-1.0, c=c, nA=n, nB=n,
               dtype=torch.float64, data=tdata)
    assert 5 < res.steps < 500
    _assert_match_jax(res, jres)


def test_config_mirrors_jax_options_and_validation():
    import dataclasses

    from admm_tpu import config as jconfig
    from admm_tpu_torch import config as tconfig

    jf = {f.name: f.default for f in dataclasses.fields(JaxConfig)}
    tf = {f.name: f.default for f in dataclasses.fields(ADMMConfig)}
    assert tf == jf
    assert tconfig._AUTO_UNROLL == jconfig._AUTO_UNROLL
    for body in tconfig._AUTO_UNROLL:
        assert (tconfig.resolve_unroll(ADMMConfig(unroll="auto"), body).unroll
                == jconfig.resolve_unroll(JaxConfig(unroll="auto"), body).unroll)
    bad = [dict(stopcond="bogus"), dict(fasttype="x"), dict(maxiters=0),
           dict(rbadaptive=True, nodualerror=True), dict(rbadaptive=True, adaptive=True),
           dict(rbadaptive=True, fast=True), dict(stallwindow=-1), dict(anderson=-1),
           dict(anderson=2, fast=True), dict(anderson=2, adaptive=True),
           dict(anderson=2, convtest=True), dict(aa_restart=1.0), dict(stalltol=1.0),
           dict(matmul_precision="fast"), dict(unroll="x"), dict(unroll=0)]
    for kw in bad:
        with pytest.raises(ValueError) as jerr:
            JaxConfig(**kw)
        with pytest.raises(ValueError) as terr:
            ADMMConfig(**kw)
        assert str(terr.value) == str(jerr.value)
    clamped = dict(fast=True, restart=1.5)
    assert ADMMConfig(**clamped).restart == JaxConfig(**clamped).restart == 0.999
    for kw in (dict(), dict(fast=True), dict(fast=True, fasttype="strong"),
               dict(convtest=True), dict(stallwindow=3), dict(stallwindow=3, domaxiters=True),
               dict(rbadaptive=True)):
        j, t = JaxConfig(**kw), ADMMConfig(**kw)
        assert (t.alg, t.needs_hnorm, t.use_stall, t.dynamic_rho, t.resolved) == (
            j.alg, j.needs_hnorm, j.use_stall, j.dynamic_rho, j.resolved)
