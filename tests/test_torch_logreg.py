"""Sparse logistic regression of the port (admm_tpu_torch/models/logreg.py)
against admm_tpu's on the same numpy inputs in f64: the dense damped Newton
x-prox (with ``newton_steps`` honored) and the matrix-free Newton-CG one, on
admm_tpu's setup carried across (``convert.lasso_data``) and on their own,
the one-vs-all ``logreg_batch`` against admm_tpu's and against the port's
serial solves, and the oracles of tests/test_logreg.py (the KKT conditions
of logregtest's instance, scipy's smooth optimum at lam = 0).  Bars: equal
steps, iterates to rtol 1e-9, histories to 1e-8 of their first value
(``_parity.assert_same_run``), unless a test states another."""

import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from admm_tpu import ADMMConfig as JaxConfig
from admm_tpu import logreg as jax_logreg
from admm_tpu import logreg_batch as jax_logreg_batch
from admm_tpu.engine import Hooks as JaxHooks
from admm_tpu.engine import admm as jax_admm
from admm_tpu_torch import ADMMConfig, Hooks, admm, get_prox_ops, logreg, logreg_batch
from admm_tpu_torch.convert import lasso_data, numpy_state

from _parity import assert_same_run

torch.set_num_threads(1)
jax_lr_mod = importlib.import_module("admm_tpu.models.logreg")
lr_mod = importlib.import_module("admm_tpu_torch.models.logreg")


def _instance(seed=3, m=300, n=10, sparse=False):
    rng = np.random.default_rng(seed)
    D = rng.standard_normal((m, n))
    w = rng.standard_normal(n) * ((rng.random(n) < 0.5) if sparse else 1.0)
    p = 1.0 / (1.0 + np.exp(-(D @ w)))
    return D, np.where(rng.random(m) < p, 1.0, -1.0)


def _kkt(D, ell, lam, z):
    # logregtest's KKT residual (admm_tpu/testers/problems.py:445-453).
    Y = D * ell[:, None]
    g = -Y.T @ (1.0 / (1.0 + np.exp(Y @ z)))
    act = np.abs(z) > 1e-8
    kkt_act = float(np.max(np.abs(g[act] + lam * np.sign(z[act])))) if act.any() else 0.0
    kkt_zero = float(max(np.max(np.abs(g[~act])) - lam, 0.0)) if (~act).any() else 0.0
    return max(kkt_act, kkt_zero)


@pytest.mark.parametrize("inner,steps", [("newton", {}), ("newton", {"newton_steps": 2}),
                                         ("newton_cg", {}),
                                         ("newton_cg", {"newton_steps": 4, "cg_steps": 12})])
def test_logreg_parity_on_carried_setup(inner, steps):
    D, ell = _instance(m=120, n=12)
    cfg = dict(maxiters=400, objevals=True)
    jpf, jpg, jobj, jdata = jax_lr_mod.make_prox_ops(jnp.asarray(D), jnp.asarray(ell), 0.2,
                                                     JaxConfig(**cfg), inner=inner, **steps)
    jres = jax_admm(jpf, jpg, JaxConfig(**cfg), A=1.0, B=-1.0, c=0.0, m=12, nA=12, nB=12,
                    hooks=JaxHooks(obj=jobj), dtype=jnp.float64, data=jdata)
    data, _ = lasso_data(numpy_state(jdata))
    pf, pg, obj, own = lr_mod.make_prox_ops(torch.from_numpy(D), ell, 0.2, ADMMConfig(**cfg),
                                            inner=inner, **steps)
    assert set(data) == set(own)
    res = admm(pf, pg, ADMMConfig(**cfg), A=1.0, B=-1.0, c=0.0, m=12, nA=12, nB=12,
               hooks=Hooks(obj=obj), dtype=torch.float64, data=data, device="cpu")
    assert res.steps > 5
    assert_same_run(res, jres)


@pytest.mark.parametrize("inner", ["newton", "newton_cg"])
def test_logreg_state_round_trips(inner):
    # The port's own setup (D2 with Newton-CG), flattened and rebuilt by
    # convert.lasso_data, gives the same tensors bit for bit.
    D, ell = _instance(m=40, n=5)
    _, _, _, data = lr_mod.make_prox_ops(torch.from_numpy(D), ell, 0.3, inner=inner)
    back, _ = lasso_data(numpy_state(data))
    assert set(back) == set(data)
    for key in data:
        assert torch.equal(back[key], data[key])


def test_dense_prox_honors_newton_steps():
    # admm_tpu's review fix: the dense path once ran 5 steps whatever
    # newton_steps said.  One x-prox from x = 0 with 1 and 5 steps differs.
    D, ell = _instance(m=80, n=6)
    _, _, _, data = lr_mod.make_prox_ops(torch.from_numpy(D), ell, 0.1)
    z = torch.zeros(6, dtype=torch.float64)
    one = lr_mod._dense_prox_f_fn(1)(z, z + 0.5, z, 1.0, data)
    five = lr_mod._dense_prox_f_fn(5)(z, z + 0.5, z, 1.0, data)
    assert lr_mod._dense_prox_f_fn(5) is lr_mod._prox_f
    assert float(torch.max(torch.abs(one - five))) > 1e-6


def test_logreg_kkt_oracle_and_parity_on_own_setup():
    # tests/test_logreg.py::test_logreg_kkt_oracle on logregtest's instance
    # (seed 1, 200 x 16, lam = 0.1 ||grad at 0||_inf), with its config.
    D, ell = _instance(seed=1, m=200, n=16, sparse=True)
    lam = 0.1 * float(np.max(np.abs(-(D * ell[:, None]).T @ np.full(200, 0.5))))
    cfg = dict(objevals=True, maxiters=2000, abstol=1e-8, reltol=1e-7)
    res = logreg(D, ell, lam, ADMMConfig(**cfg), device="cpu")
    jres = jax_logreg(D, ell, lam, JaxConfig(**cfg))
    assert_same_run(res, jres)
    z = res.zopt.numpy()
    assert _kkt(D, ell, lam, z) <= 1e-3
    assert res.steps < 2000
    assert np.sum(np.abs(z) < 1e-8) > 0


def test_logreg_lam0_matches_scipy_smooth_optimum():
    from scipy.optimize import minimize

    D, ell = _instance()
    Y = D * ell[:, None]
    f = lambda x: np.sum(np.logaddexp(0.0, -(Y @ x)))  # noqa: E731
    g = lambda x: -Y.T @ (1.0 / (1.0 + np.exp(Y @ x)))  # noqa: E731
    ref = minimize(f, np.zeros(10), jac=g, method="BFGS", options={"gtol": 1e-10})
    res = logreg(D, ell, 0.0, ADMMConfig(maxiters=3000, abstol=1e-9, reltol=1e-8), device="cpu")
    x = res.xopt.numpy()
    assert abs(f(x) - ref.fun) <= 1e-5 * (1.0 + abs(ref.fun)), (f(x), ref.fun)
    np.testing.assert_allclose(x, ref.x, rtol=1e-3, atol=1e-4)


def test_logreg_newton_cg_matches_dense_newton():
    D, ell = _instance(m=300, n=40)
    cfg = ADMMConfig(maxiters=3000, abstol=1e-9, reltol=1e-9)
    dense = logreg(D, ell, 0.1, cfg, device="cpu")
    cg = logreg(D, ell, 0.1, cfg, inner="newton_cg", device="cpu")
    assert cg.steps == dense.steps
    np.testing.assert_allclose(cg.zopt.numpy(), dense.zopt.numpy(), atol=1e-7)


def test_logreg_validation_registry_and_demo_mode():
    rng = np.random.default_rng(0)
    D = rng.standard_normal((40, 6))
    with pytest.raises(ValueError, match="labels"):
        logreg(D, rng.standard_normal(40), 0.1, device="cpu")
    with pytest.raises(ValueError, match="nonnegative"):
        logreg(D, np.sign(rng.standard_normal(40)), -0.5, device="cpu")
    with pytest.raises(ValueError, match="inner"):
        logreg(D, np.sign(rng.standard_normal(40)), 0.1, inner="lbfgs", device="cpu")
    with pytest.raises(NotImplementedError, match="slice 11"):
        logreg()
    ell = np.sign(rng.standard_normal(40))
    pf, pg, obj = get_prox_ops("logreg", {"D": D, "ell": ell, "lam": 0.1}, device="cpu")
    z = torch.zeros(6, dtype=torch.float64)
    x = pf(z, z, z, 1.0)
    assert x.shape == (6,) and torch.isfinite(x).all() and float(obj(x, x)) > 0


@pytest.mark.parametrize("inner", ["newton_cg", "newton"])
def test_logreg_batch_matches_jax_and_solo_lanes(inner):
    # tests/test_logreg.py::test_logreg_batch_matches_solo_lanes: one-vs-all
    # lanes against admm_tpu's logreg_batch (equal steps, rtol 1e-9) and
    # against the port's serial solve at the batch's 4 x 12 knobs (dense:
    # equal steps, rtol 1e-9: the lanes' batched LU and GEMMs round apart
    # from the serial ones at ~1e-10; CG: the lanes' GEMMs sum in another order than
    # the serial GEMVs and the CG recurrence amplifies it, so the bar is
    # admm_tpu's own: steps within 2, z to 1e-7).
    rng = np.random.default_rng(7)
    m, n, K = 160, 8, 3
    D = rng.standard_normal((m, n))
    y = rng.integers(0, K, size=m)
    ells = np.stack([np.where(y == k, 1.0, -1.0) for k in range(K)])
    cfg = dict(maxiters=800)
    out = logreg_batch(D, ells, 0.1, ADMMConfig(**cfg), inner=inner, device="cpu")
    jout = jax_logreg_batch(D, ells, 0.1, JaxConfig(**cfg), inner=inner)
    assert out.steps.tolist() == np.asarray(jout.steps).tolist()
    np.testing.assert_allclose(out.zopt.numpy(), np.asarray(jout.zopt), rtol=1e-9,
                               atol=1e-9 * np.abs(np.asarray(jout.zopt)).max())
    for k in range(K):
        solo = logreg(D, ells[k], 0.1, ADMMConfig(**cfg), inner=inner, newton_steps=4,
                      cg_steps=12, device="cpu")
        if inner == "newton":
            assert int(out.steps[k]) == solo.steps
            np.testing.assert_allclose(out.zopt[k].numpy(), solo.zopt.numpy(), rtol=1e-9,
                                       atol=1e-9 * np.abs(solo.zopt.numpy()).max())
        else:
            assert abs(int(out.steps[k]) - solo.steps) <= 2
            np.testing.assert_allclose(out.zopt[k].numpy(), solo.zopt.numpy(), atol=1e-7)
    with pytest.raises(ValueError, match="label lanes"):
        logreg_batch(D, ells * 0.5, 0.1, ADMMConfig(**cfg), device="cpu")
