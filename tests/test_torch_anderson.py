"""Anderson acceleration of the port (admm_tpu_torch/anderson.py, and the
engine's ``ADMMConfig.anderson``) against admm_tpu's in f64.

The cases mirror tests/test_anderson.py's engine cases (:33, :45, :76,
:93, :175, :396): AA reaches the same optimum in fewer steps, the model
problem's closed form, the safeguard's fallback is the plain trajectory
bit for bit, unroll is exact, relaxation composes, and the config rules.
The window helper is also held against a NumPy transcription of
admm_tpu's window algebra, and over several leaves against one
concatenated leaf.
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
from admm_tpu_torch import ADMMConfig, Hooks, admm, lasso, model
from admm_tpu_torch.anderson import AndersonWindow
from admm_tpu_torch.convert import lasso_data, numpy_state

torch.set_num_threads(1)
jax_lasso_mod = importlib.import_module("admm_tpu.models.lasso")
lasso_mod = importlib.import_module("admm_tpu_torch.models.lasso")

TOL = dict(abstol=1e-8, reltol=1e-8, maxiters=20000)


@pytest.fixture
def rng():
    return np.random.default_rng(0)


def _lasso_instance(rng, m=200, n=400):
    D = rng.standard_normal((m, n))
    s = rng.standard_normal(m)
    lam = 0.1 * np.max(np.abs(D.T @ s))
    return D, s, lam


def _lasso_obj(D, s, lam, x):
    x = np.asarray(x)
    return 0.5 * np.sum((D @ x - s) ** 2) + lam * np.sum(np.abs(x))


def _carried(D, s, lam, cfg_kw):
    """admm_tpu's AA solve of the fat LASSO and the port's on its carried
    setup: (port result, admm_tpu result)."""
    n = D.shape[1]
    _, _, _, jdata = jax_lasso_mod.make_prox_ops(jnp.asarray(D), jnp.asarray(s), lam,
                                                 JaxConfig(**cfg_kw))
    jres = jax_admm(jax_lasso_mod._prox_f_fat_static, jax_lasso_mod._prox_g,
                    JaxConfig(**cfg_kw), m=n, hooks=JaxHooks(obj=jax_lasso_mod._obj),
                    dtype=jnp.float64, data=jdata)
    data, _ = lasso_data(numpy_state(jdata))
    res = admm(lasso_mod._prox_f_fat_static, lasso_mod._prox_g, ADMMConfig(**cfg_kw), m=n,
               hooks=Hooks(obj=lasso_mod._obj), dtype=torch.float64, data=data)
    return res, jres


def _assert_match(res, jres):
    assert res.steps == jres.steps and res.diverged == bool(jres.diverged)
    for name in ("xopt", "zopt", "uopt"):
        np.testing.assert_allclose(getattr(res, name).numpy(),
                                   np.asarray(getattr(jres, name)), rtol=1e-9, atol=1e-10)
    for name in jres.hist:
        # 1e-8 of the first value, or of the largest where the first is 0.
        ref = jres.trace(name)
        scale = abs(ref[0]) or np.nanmax(np.abs(ref))
        np.testing.assert_allclose(res.trace(name), ref, rtol=0, atol=1e-8 * scale)


def test_lasso_fewer_steps_same_optimum(rng):
    D, s, lam = _lasso_instance(rng)
    r_plain = lasso(D, s, lam, ADMMConfig(**TOL), device="cpu")
    r_aa = lasso(D, s, lam, ADMMConfig(anderson=10, **TOL), device="cpu")
    assert r_aa.steps < r_plain.steps * 0.6
    f0 = _lasso_obj(D, s, lam, r_plain.zopt)
    f1 = _lasso_obj(D, s, lam, r_aa.zopt)
    assert abs(f1 - f0) <= 1e-9 * (1.0 + abs(f0))
    np.testing.assert_allclose(r_aa.zopt.numpy(), r_plain.zopt.numpy(), atol=1e-5)
    # admm_tpu's AA solve of the same instance on the same setup: the
    # window's solve rounds differently in the two LAPACKs and AA carries
    # it on, so the bars hold over the first 60 steps of the run.
    res, jres = _carried(D, s, lam, dict(TOL, anderson=10, maxiters=60))
    _assert_match(res, jres)


def test_model_reaches_closed_form(rng):
    m = n = 64
    P = rng.standard_normal((m, n))
    Q = rng.standard_normal((m, n))
    r = rng.standard_normal(m)
    s = rng.standard_normal(m)
    xstar = np.linalg.solve(P.T @ P + Q.T @ Q, P.T @ r + Q.T @ s)
    res = model(P, Q, r, s, ADMMConfig(anderson=8, **TOL), device="cpu")
    assert not res.diverged
    np.testing.assert_allclose(res.xopt.numpy(), xstar, atol=1e-6)


def test_safeguard_fallback_is_exact_plain(rng):
    # aa_gmax below any attainable ||gamma||_1 rejects every candidate:
    # the fallback is the plain trajectory bit for bit.
    D, s, lam = _lasso_instance(rng, 80, 160)
    cfg = dict(abstol=1e-6, reltol=1e-6, maxiters=3000)
    r_plain = lasso(D, s, lam, ADMMConfig(**cfg), device="cpu")
    r_gated = lasso(D, s, lam, ADMMConfig(anderson=5, aa_gmax=1e-300, **cfg), device="cpu")
    assert r_gated.steps == r_plain.steps
    for name in ("xopt", "zopt", "uopt"):
        assert torch.equal(getattr(r_gated, name), getattr(r_plain, name))
    j_gated = jax_lasso(D, s, lam, JaxConfig(anderson=5, aa_gmax=1e-300, **cfg))
    assert r_gated.steps == j_gated.steps


def test_unroll_bit_exact(rng):
    D, s, lam = _lasso_instance(rng, 120, 240)
    base = dict(abstol=1e-7, reltol=1e-7, maxiters=4000, anderson=6)
    r1 = lasso(D, s, lam, ADMMConfig(unroll=1, **base), device="cpu")
    r4 = lasso(D, s, lam, ADMMConfig(unroll=4, **base), device="cpu")
    assert r1.steps == r4.steps
    for name in ("xopt", "zopt", "uopt"):
        assert torch.equal(getattr(r1, name), getattr(r4, name))
    for name in r1.hist:
        np.testing.assert_array_equal(r1.hist[name].numpy(), r4.hist[name].numpy())


def test_relax_composes(rng):
    D, s, lam = _lasso_instance(rng, 100, 200)
    r = lasso(D, s, lam, ADMMConfig(relax=1.5, anderson=8, abstol=1e-7, reltol=1e-7,
                                    maxiters=5000), device="cpu")
    r_ref = lasso(D, s, lam, ADMMConfig(abstol=1e-7, reltol=1e-7, maxiters=20000),
                  device="cpu")
    f0 = _lasso_obj(D, s, lam, r_ref.zopt)
    f1 = _lasso_obj(D, s, lam, r.zopt)
    assert not r.diverged
    assert abs(f1 - f0) <= 1e-7 * (1.0 + abs(f0))
    res, jres = _carried(D, s, lam, dict(relax=1.5, anderson=8, maxiters=40))
    _assert_match(res, jres)


@pytest.mark.parametrize("bad", [
    dict(anderson=5, fast=True),
    dict(anderson=5, adaptive=True),
    dict(anderson=5, rbadaptive=True),
    dict(anderson=5, convtest=True),
    dict(anderson=5, stopcond="hnorm"),
    dict(anderson=-1),
    dict(anderson=5, aa_restart=1.0),
])
def test_config_validation(bad):
    with pytest.raises(ValueError) as terr:
        ADMMConfig(**bad)
    with pytest.raises(ValueError) as jerr:
        JaxConfig(**bad)
    assert str(terr.value) == str(jerr.value)


# ---- the window helper -------------------------------------------------


def _numpy_window(cfg, S, T):
    """admm_tpu engine.py:744-790 in NumPy over a sequence of (s_in, t_out)
    pairs of one flat leaf: the next starts, cnt and best after each."""
    m, R = cfg.anderson, cfg.anderson + 1
    n = S[0].size
    aF, aT = np.zeros((R, n)), np.zeros((R, n))
    cnt, best, out = 0, np.inf, []
    for s_in, t_out in zip(S, T):
        f = t_out - s_in
        fn2 = np.sum(f * f)
        grew = fn2 > cfg.aa_restart ** 2 * best
        cnt = 0 if grew else cnt
        best = fn2 if grew else min(best, fn2)
        aF[cnt % R], aT[cnt % R] = f, t_out
        js = (cnt - m + np.arange(R)) % R
        dF, dT = np.diff(aF[js], axis=0), np.diff(aT[js], axis=0)
        mk = min(cnt, m)
        live = (np.arange(m) >= m - mk)[:, None]
        dF, dT = np.where(live, dF, 0.0), np.where(live, dT, 0.0)
        G = dF @ dF.T
        lam = cfg.aa_reg * np.trace(G) + np.finfo(float).eps
        gamma = np.linalg.solve(G + lam * np.eye(m), dF @ f)
        cand = t_out - gamma @ dT
        ok = np.all(np.isfinite(cand)) and np.sum(np.abs(gamma)) <= cfg.aa_gmax and mk >= 1
        out.append((cand if ok else t_out, cnt + 1, best))
        cnt += 1
    return out


def _sequence(n, steps, seed=3):
    """A contracting affine map's orbit with a jump (a restart) midway."""
    rng = np.random.default_rng(seed)
    M = 0.9 * np.linalg.qr(rng.standard_normal((n, n)))[0]
    b = rng.standard_normal(n)
    s = rng.standard_normal(n)
    S, T = [], []
    for k in range(steps):
        if k == steps // 2:
            s = s + 50.0 * rng.standard_normal(n)
        t = M @ s + b
        S.append(s)
        T.append(t)
        s = t
    return S, T


@pytest.mark.parametrize("m", [1, 3, 6])
def test_window_matches_numpy_transcription(m):
    cfg = ADMMConfig(anderson=m)
    S, T = _sequence(12, 20)
    ref = _numpy_window(cfg, S, T)
    win = AndersonWindow(cfg, [12], dtype=torch.float64, device="cpu")
    cnt, best = win.initial()
    no = torch.zeros((), dtype=torch.bool)
    restarted = False
    for (s_in, t_out), (nxt_ref, cnt_ref, best_ref) in zip(zip(S, T), ref):
        (nxt,), cnt, best = win.step([torch.from_numpy(s_in)], [torch.from_numpy(t_out)],
                                     cnt, best, done=no)
        restarted |= int(cnt) == 1 and len(S) > 1
        assert int(cnt) == cnt_ref
        np.testing.assert_allclose(float(best), best_ref, rtol=1e-14)
        np.testing.assert_allclose(nxt.numpy(), nxt_ref, rtol=1e-9, atol=1e-12)
    assert restarted


def test_window_over_leaves_equals_one_concatenated_leaf():
    # Per-leaf rings and contractions give the concatenated leaf's step up
    # to summation order; a frozen step writes only the spare row.
    cfg = ADMMConfig(anderson=4)
    S, T = _sequence(10, 9, seed=5)
    split = lambda v: [torch.from_numpy(v[:3]), torch.from_numpy(v[3:].reshape(7, 1))]
    one = AndersonWindow(cfg, [10], dtype=torch.float64, device="cpu")
    two = AndersonWindow(cfg, [3, 7], dtype=torch.float64, device="cpu")
    c1, b1 = one.initial()
    c2, b2 = two.initial()
    no = torch.zeros((), dtype=torch.bool)
    for s_in, t_out in zip(S, T):
        (n1,), c1, b1 = one.step([torch.from_numpy(s_in)], [torch.from_numpy(t_out)],
                                 c1, b1, done=no)
        n2, c2, b2 = two.step(split(s_in), split(t_out), c2, b2, done=no)
        assert n2[1].shape == (7, 1) and int(c1) == int(c2)
        np.testing.assert_allclose(torch.cat([n2[0], n2[1].reshape(-1)]).numpy(), n1.numpy(),
                                   rtol=1e-10, atol=1e-12)
    F = [f.clone() for f in two.F]
    yes = torch.ones((), dtype=torch.bool)
    two.step(split(S[0]), split(T[0]), c2, b2, done=no, frozen=yes)
    for before, after in zip(F, two.F):
        assert torch.equal(before[:-1], after[:-1])  # only the spare row moved
    # Done: the candidate is refused and the plain output passes through.
    nxt, _, _ = two.step(split(S[1]), split(T[1]), c2, b2, done=yes)
    assert torch.equal(torch.cat([nxt[0], nxt[1].reshape(-1)]), torch.from_numpy(T[1]))
