"""Robust PCA and matrix completion of the port (admm_tpu_torch/models/rpca.py,
models/matrixcompletion.py) against admm_tpu's on the same numpy inputs in
f64: the SVT helpers, both solvers with the exact and the randomized SVT on
admm_tpu's setup carried across (``convert.matrix_data``, the sketch's G
drawn from ``PRNGKey(seed)`` as admm_tpu draws it) and on their own, the
state round trip, and the oracles of tests/test_matrixcompletion.py and of
TestRobustPCA (tests/test_extra_models.py) through the port.  Bars: equal
steps, iterates to rtol 1e-9, histories to 1e-8 of their first value
(``_parity.assert_same_run``)."""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from admm_tpu import ADMMConfig as JaxConfig
from admm_tpu import matrixcompletion as jax_mc
from admm_tpu import rpca as jax_rpca
from admm_tpu.engine import Hooks as JaxHooks
from admm_tpu.engine import admm as jax_admm
from admm_tpu_torch import ADMMConfig, Hooks, admm, get_prox_ops, matrixcompletion, rpca
from admm_tpu_torch.convert import matrix_data, numpy_state

from _parity import assert_same_run

torch.set_num_threads(1)
jax_mc_mod = importlib.import_module("admm_tpu.models.matrixcompletion")
jax_rpca_mod = importlib.import_module("admm_tpu.models.rpca")
mc_mod = importlib.import_module("admm_tpu_torch.models.matrixcompletion")
rpca_mod = importlib.import_module("admm_tpu_torch.models.rpca")

_MC_CFG = dict(maxiters=4000, abstol=1e-10, reltol=1e-8)


def _planted(rng, m=36, n=28, r=2, p=0.7):
    # tests/test_matrixcompletion.py's generator.
    A = rng.standard_normal((m, r))
    B = rng.standard_normal((n, r))
    M0 = A @ B.T
    mask = rng.random((m, n)) < p
    assert mask.any(axis=0).all() and mask.any(axis=1).all()
    return M0, mask


def _plant(rng, m=60, n=50, r=3, frac=0.05, amp=5.0):
    # TestRobustPCA._plant (tests/test_extra_models.py).
    L0 = rng.standard_normal((m, r)) @ rng.standard_normal((r, n))
    S0 = (rng.random((m, n)) < frac) * (amp * rng.standard_normal((m, n)))
    return L0, S0


def _jax_G(shape, rank, seed=0, oversample=10):
    k = min(rank + oversample, min(shape))
    return np.asarray(jax.random.normal(jax.random.PRNGKey(seed), (shape[1], k), jnp.float64))


def test_svt_and_randomized_svt_match_jax():
    # One call each, rtol 1e-12 of the result's scale; the randomized SVT
    # with admm_tpu's own G, at a rank the sketch holds (exact) and below it.
    rng = np.random.default_rng(3)
    V = rng.standard_normal((40, 6)) @ rng.standard_normal((6, 30)) + 0.01 * rng.standard_normal((40, 30))
    ref = np.asarray(jax_mc_mod.svt(jnp.asarray(V), 0.5))
    got = mc_mod.svt(torch.from_numpy(V), 0.5).numpy()
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-12 * np.abs(ref).max())
    for k in (12, 4):
        G = np.array(jax.random.normal(jax.random.PRNGKey(5), (30, k), jnp.float64))
        ref = np.asarray(jax_mc_mod.randomized_svt(jnp.asarray(V), 0.5, k, 2, 5))
        got = mc_mod.randomized_svt(torch.from_numpy(V), 0.5, torch.from_numpy(G), 2).numpy()
        np.testing.assert_allclose(got, ref, rtol=0, atol=1e-11 * np.abs(ref).max())


@pytest.mark.parametrize("method", ["exact", "rsvd"])
def test_rpca_parity_on_carried_setup(method):
    rng = np.random.default_rng(11)
    L0, S0 = _plant(rng, m=40, n=32, r=2)
    M = L0 + S0
    kw = dict(prox_method=method, rank=5 if method == "rsvd" else None)
    cfg = dict(maxiters=300, abstol=1e-9, reltol=1e-9, objevals=True)
    jpf, jpg, jobj, jdata = jax_rpca_mod.make_prox_ops(jnp.asarray(M), None, JaxConfig(**cfg), **kw)
    jres = jax_admm(jpf, jpg, JaxConfig(**cfg), A=1.0, B=1.0, c=jnp.asarray(M),
                    shape_x=M.shape, shape_z=M.shape, hooks=JaxHooks(obj=jobj),
                    dtype=jnp.float64, data=jdata)
    state = numpy_state(jdata)
    if method == "rsvd":
        state["G"] = _jax_G(M.shape, 5)
    data, _ = matrix_data(state)
    pf, pg, obj, _ = rpca_mod.make_prox_ops(torch.from_numpy(M), None, ADMMConfig(**cfg), **kw)
    res = admm(pf, pg, ADMMConfig(**cfg), A=1.0, B=1.0, c=torch.from_numpy(M),
               shape_x=M.shape, shape_z=M.shape, hooks=Hooks(obj=obj), data=data,
               device="cpu")
    assert 5 < res.steps < 300
    assert_same_run(res, jres)


def test_rpca_parity_on_own_setup_and_state_round_trip():
    rng = np.random.default_rng(12)
    L0, S0 = _plant(rng, m=36, n=30, r=2)
    M = L0 + S0
    cfg = dict(maxiters=500, abstol=1e-9, reltol=1e-9)
    res = rpca(M, config=ADMMConfig(**cfg), device="cpu")
    jres = jax_rpca(M, config=JaxConfig(**cfg))
    assert_same_run(res, jres)
    # The state round trip: the port's own setup, flattened and rebuilt,
    # gives the same tensors bit for bit (G included).
    _, _, _, data = rpca_mod.make_prox_ops(torch.from_numpy(M), None, ADMMConfig(),
                                           prox_method="rsvd", rank=3)
    back, _ = matrix_data(numpy_state(data))
    assert set(back) == set(data)
    for key in data:
        assert torch.equal(back[key], data[key])


@pytest.mark.parametrize("mu", [None, 5.0])
def test_matrixcompletion_state_round_trips(mu):
    # The port's own setup (mask, mu and the sketch's G included),
    # flattened and rebuilt, gives the same tensors bit for bit.
    rng = np.random.default_rng(4)
    M0, mask = _planted(rng, m=20, n=16)
    _, _, _, data = mc_mod.make_prox_ops(torch.from_numpy(M0 * mask), mask, mu,
                                         prox_method="rsvd", rank=3, seed=7)
    back, _ = matrix_data(numpy_state(data))
    assert set(back) == set(data) and "G" in back
    for key in data:
        assert torch.equal(back[key], data[key])


def test_rpca_rsvd_own_stream_matches_exact_where_rank_fits():
    # The port draws its own G; where rank(L) <= k both sketches are exact,
    # so the port's rsvd run, the port's exact run and admm_tpu's exact run
    # agree (tests/test_extra_models.py:395 holds admm_tpu's rsvd the same way).
    rng = np.random.default_rng(0)
    L0, S0 = _plant(rng, m=72, n=60, r=3)
    cfg = dict(maxiters=3000, abstol=1e-9, reltol=1e-9)
    exact = rpca(L0 + S0, config=ADMMConfig(**cfg), device="cpu")
    rs = rpca(L0 + S0, config=ADMMConfig(**cfg), prox_method="rsvd", rank=6, device="cpu")
    jexact = jax_rpca(L0 + S0, config=JaxConfig(**cfg))
    np.testing.assert_allclose(rs.xopt.numpy(), exact.xopt.numpy(), atol=1e-6)
    np.testing.assert_allclose(exact.xopt.numpy(), np.asarray(jexact.xopt), rtol=0, atol=1e-9 * np.abs(L0).max())
    assert np.linalg.norm(rs.xopt.numpy() - L0) <= 1e-6 * np.linalg.norm(L0)
    with pytest.raises(ValueError, match="rank"):
        rpca(L0 + S0, prox_method="rsvd", device="cpu")
    with pytest.raises(ValueError, match="prox_method"):
        rpca(L0 + S0, prox_method="power", device="cpu")


def test_rpca_exact_recovery_oracle():
    # TestRobustPCA.test_exact_recovery and test_objective_beats_truth_perturbation.
    rng = np.random.default_rng(0)
    L0, S0 = _plant(rng)
    res = rpca(L0 + S0, config=ADMMConfig(maxiters=3000, abstol=1e-10, reltol=1e-10),
               device="cpu")
    L, S = res.xopt.numpy(), res.zopt.numpy()
    assert res.steps < 3000 and not res.diverged
    assert np.linalg.norm(L - L0) <= 1e-6 * np.linalg.norm(L0)
    assert np.linalg.norm(S - S0) <= 1e-6 * np.linalg.norm(S0)
    assert np.linalg.matrix_rank(L, tol=1e-5) == 3
    np.testing.assert_allclose(L + S, L0 + S0, atol=1e-6)
    d = {"lam": torch.tensor(1.0 / np.sqrt(60.0), dtype=torch.float64)}
    f_admm = float(rpca_mod._obj(res.xopt, res.zopt, d))
    f_plant = float(rpca_mod._obj(torch.from_numpy(L0), torch.from_numpy(S0), d))
    assert f_admm <= f_plant * (1 + 1e-6)


def test_rpca_rectangular_validation_and_registry():
    rng = np.random.default_rng(0)
    with pytest.raises(ValueError, match="matrix"):
        rpca(np.ones(5), device="cpu")
    L0, S0 = _plant(rng, m=50, n=30, r=2)
    res = rpca(L0 + S0, config=ADMMConfig(maxiters=3000, abstol=1e-9, reltol=1e-9), device="cpu")
    assert np.linalg.norm(res.xopt.numpy() - L0) <= 1e-5 * np.linalg.norm(L0)
    pf, pg, obj = get_prox_ops("rpca", M=L0 + S0, device="cpu")
    assert callable(pf) and callable(pg) and callable(obj)


@pytest.mark.parametrize("form", ["exact", "noisy", "rsvd"])
def test_matrixcompletion_parity_on_carried_setup(form):
    rng = np.random.default_rng(21)
    M0, mask = _planted(rng, m=30, n=24)
    mu = 20.0 if form == "noisy" else None
    kw = dict(prox_method="rsvd", rank=3) if form == "rsvd" else {}
    cfg = dict(maxiters=200, abstol=1e-10, reltol=1e-8, objevals=True)
    jpf, jpg, jobj, jdata = jax_mc_mod.make_prox_ops(jnp.asarray(M0 * mask), jnp.asarray(mask),
                                                     mu, JaxConfig(**cfg), **kw)
    jres = jax_admm(jpf, jpg, JaxConfig(**cfg), A=1.0, B=-1.0, c=0.0, shape_x=M0.shape,
                    shape_z=M0.shape, hooks=JaxHooks(obj=jobj), dtype=jnp.float64, data=jdata)
    state = numpy_state(jdata)
    if form == "rsvd":
        state["G"] = _jax_G(M0.shape, 3)
    data, _ = matrix_data(state)
    pf, pg, obj, _ = mc_mod.make_prox_ops(torch.from_numpy(M0 * mask), mask, mu,
                                          ADMMConfig(**cfg), **kw)
    res = admm(pf, pg, ADMMConfig(**cfg), A=1.0, B=-1.0, c=0.0, shape_x=M0.shape,
               shape_z=M0.shape, hooks=Hooks(obj=obj), data=data, dtype=torch.float64,
               device="cpu")
    assert res.steps > 5
    assert_same_run(res, jres)


@pytest.mark.parametrize("mu", [None, 1e4])
def test_matrixcompletion_parity_on_own_setup(mu):
    rng = np.random.default_rng(0)
    M0, mask = _planted(rng)
    res = matrixcompletion(M0 * mask, mask, mu=mu, config=ADMMConfig(**_MC_CFG), device="cpu")
    jres = jax_mc(M0 * mask, mask, mu=mu, config=JaxConfig(**_MC_CFG))
    assert_same_run(res, jres)


def test_matrixcompletion_recovers_planted_low_rank():
    rng = np.random.default_rng(0)
    M0, mask = _planted(rng)
    res = matrixcompletion(M0 * mask, mask, config=ADMMConfig(**_MC_CFG), device="cpu")
    rel = np.linalg.norm(res.zopt.numpy() - M0) / np.linalg.norm(M0)
    assert rel < 1e-4, rel
    np.testing.assert_allclose(res.xopt.numpy()[mask], M0[mask], atol=1e-12)


def test_matrixcompletion_unobserved_entries_ignored():
    rng = np.random.default_rng(0)
    M0, mask = _planted(rng)
    garbage = M0 * mask + 100.0 * ~mask
    res = matrixcompletion(garbage, mask, mu=1e4, config=ADMMConfig(**_MC_CFG), device="cpu")
    rel = np.linalg.norm(res.zopt.numpy() - M0) / np.linalg.norm(M0)
    assert rel < 1e-3, rel


def test_matrixcompletion_rsvd_matches_exact():
    rng = np.random.default_rng(0)
    M0, mask = _planted(rng, m=48, n=40, r=3)
    cfg = ADMMConfig(**_MC_CFG)
    exact = matrixcompletion(M0 * mask, mask, config=cfg, device="cpu")
    rs = matrixcompletion(M0 * mask, mask, config=cfg, prox_method="rsvd", rank=5, device="cpu")
    np.testing.assert_allclose(rs.zopt.numpy(), exact.zopt.numpy(), atol=1e-6)


def test_matrixcompletion_large_mu_approaches_exact_and_denoises():
    rng = np.random.default_rng(0)
    M0, mask = _planted(rng)
    cfg = ADMMConfig(**_MC_CFG)
    exact = matrixcompletion(M0 * mask, mask, config=cfg, device="cpu")
    noisy = matrixcompletion(M0 * mask, mask, mu=1e6, config=cfg, device="cpu")
    np.testing.assert_allclose(noisy.zopt.numpy(), exact.zopt.numpy(), atol=1e-3)
    M0, mask = _planted(rng, p=0.8)
    obs = (M0 + 0.05 * rng.standard_normal(M0.shape)) * mask
    Z = matrixcompletion(obs, mask, mu=20.0, config=cfg, device="cpu").zopt.numpy()
    assert np.linalg.norm((Z - M0)[mask]) < np.linalg.norm((obs - M0)[mask])
    s = np.linalg.svd(Z, compute_uv=False)
    assert s[2] < 0.05 * s[0]


def test_matrixcompletion_validation_and_registry():
    with pytest.raises(ValueError, match="mask"):
        matrixcompletion(np.zeros((4, 5)), np.ones((4, 4)), device="cpu")
    with pytest.raises(ValueError, match="mu"):
        matrixcompletion(np.zeros((4, 4)), np.ones((4, 4)), mu=-1.0, device="cpu")
    with pytest.raises(ValueError, match="rank"):
        matrixcompletion(np.zeros((4, 4)), np.ones((4, 4)), prox_method="rsvd", device="cpu")
    rng = np.random.default_rng(0)
    M0, mask = _planted(rng, m=16, n=12)
    pf, pg, obj = get_prox_ops("matrixcompletion", {"M": M0 * mask, "mask": mask},
                               device="cpu")
    Z = torch.zeros(M0.shape, dtype=torch.float64)
    X = pf(Z, Z, Z, 1.0)
    np.testing.assert_allclose(X.numpy()[mask], M0[mask], atol=0)
    assert float(obj(X, X)) > 0
