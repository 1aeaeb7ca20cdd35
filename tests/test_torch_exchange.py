"""Exchange ADMM of the port (admm_tpu_torch.parallel.exchange) on a
stacked CPU mesh of 8 shards: the twins of tests/test_exchange.py.  Each
holds the port to the original's oracles (the closed-form market
equilibrium, the agents' KKT conditions, the core engine on the stacked
formulation), and the runs whose trajectory is deterministic to the
rounding to admm_tpu's run on its 8-device CPU mesh in f64 (equal steps,
iterates and histories within tests/_parity.py's bar), on admm_tpu's
carried setup and on the port's own.  The accelerated (weak) mode's
restart flags turn on ULP-level differences of the reduction order
(admm_tpu's own run takes 142 steps on one device and 138 on eight on the
instance of test_fast_weak_steps_follow_the_reduction_order), so its
twins compare the d-value prefix and the equilibrium, as the original
does against the engine."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec

import admm_tpu as J
import admm_tpu.parallel as JP
import admm_tpu_torch as T
import admm_tpu_torch.parallel as TP
from admm_tpu.parallel import exchange as JX
from admm_tpu_torch import convert
from admm_tpu_torch.ops.prox import soft_threshold
from admm_tpu_torch.parallel import exchange as TX

from _parity import assert_same_run

torch.set_num_threads(1)

CPU8 = TP.make_mesh(8, device="cpu")
_KW = dict(maxiters=20000, abstol=1e-11, reltol=1e-11)


def _instance(rng, W=8, m=12, n=6):
    return rng.standard_normal((W, m, n)), rng.standard_normal((W, m))


def _equilibrium(As, bs):
    Ginv = np.stack([np.linalg.inv(A.T @ A) for A in As])
    Atb = np.einsum("wmi,wm->wi", As, bs)
    nu = np.linalg.solve(Ginv.sum(0), np.einsum("wij,wj->i", Ginv, Atb))
    return np.einsum("wij,wj->wi", Ginv, Atb - nu[None, :]), nu


def _both(As, bs, mesh=CPU8, **kw):
    """The port's and admm_tpu's solve of one instance."""
    cfg = {**_KW, **kw}
    return (TP.exchange_quadratic(As, bs, T.ADMMConfig(**cfg), mesh=mesh),
            JP.exchange_quadratic(As, bs, J.ADMMConfig(**cfg)))


class TestExchangeQuadratic:
    def test_reaches_market_equilibrium(self, rng):
        As, bs = _instance(rng)
        xs, nu = _equilibrium(As, bs)
        res, jres = _both(As, bs)
        got = res.xopt.numpy()
        np.testing.assert_allclose(got, xs, atol=1e-7)
        assert np.linalg.norm(got.sum(0)) <= 1e-7
        np.testing.assert_allclose(res.rho_final * res.uopt.numpy(), nu, atol=1e-7)
        assert not res.diverged
        assert_same_run(res, jres)
        np.testing.assert_allclose(res.extra["xbar"].numpy(), np.asarray(jres.extra["xbar"]),
                                   rtol=0, atol=1e-9 * np.max(np.abs(xs)))

    def test_price_is_shared_gradient(self, rng):
        As, bs = _instance(rng, W=8, m=10, n=4)
        res = TP.exchange_quadratic(As, bs, T.ADMMConfig(**_KW), mesh=CPU8)
        x, nu = res.xopt.numpy(), res.rho_final * res.uopt.numpy()
        for i in range(As.shape[0]):
            np.testing.assert_allclose(As[i].T @ (As[i] @ x[i] - bs[i]), -nu, atol=1e-6)

    def test_matches_fewer_agents_than_devices(self, rng):
        As, bs = _instance(rng, W=4)
        xs, _ = _equilibrium(As, bs)
        res, jres = _both(As, bs)
        np.testing.assert_allclose(res.xopt.numpy(), xs, atol=1e-7)
        assert res.extra["nagents"] == 4 and res.extra["mesh"].size == 4
        assert_same_run(res, jres)

    def test_more_agents_than_devices(self, rng):
        As, bs = _instance(rng, W=16, m=9, n=5)
        xs, _ = _equilibrium(As, bs)
        res = TP.exchange_quadratic(As, bs, T.ADMMConfig(**_KW), mesh=CPU8)
        np.testing.assert_allclose(res.xopt.numpy(), xs, atol=1e-7)

    def test_warm_start_resumes(self, rng):
        As, bs = _instance(rng)
        cold = TP.exchange_quadratic(As, bs, T.ADMMConfig(**_KW), mesh=CPU8)
        warm = TP.exchange_quadratic(As, bs, T.ADMMConfig(**_KW), mesh=CPU8, xi0=cold.xopt,
                                     u0=cold.uopt)
        assert warm.steps <= max(3, cold.steps // 10)

    def test_rbadaptive_agrees(self, rng):
        As, bs = _instance(rng)
        xs, _ = _equilibrium(As, bs)
        res, jres = _both(As, bs, rbadaptive=True)
        np.testing.assert_allclose(res.xopt.numpy(), xs, atol=1e-7)
        assert_same_run(res, jres)

    def test_stall_detector_flags_plateau(self, rng):
        As, bs = _instance(rng)
        res = TP.exchange_quadratic(As, bs, T.ADMMConfig(maxiters=20000, abstol=1e-30,
                                                         reltol=1e-30, stallwindow=50),
                                    mesh=CPU8)
        assert res.stalled and res.steps < 20000

    def test_record_iterates_traces_aggregates(self, rng):
        As, bs = _instance(rng)
        kw = dict(maxiters=2000, abstol=1e-9, reltol=1e-9, record_iterates=True)
        res = TP.exchange_quadratic(As, bs, T.ADMMConfig(**kw), mesh=CPU8)
        k = res.steps
        assert np.isfinite(res.trace("xvals")[:k]).all()
        norms = np.linalg.norm(res.trace("xvals"), axis=1)
        assert norms[-1] < norms[0]
        jres = JP.exchange_quadratic(As, bs, J.ADMMConfig(**kw))
        assert res.steps == jres.steps
        for name in ("xvals", "uvals"):
            ref = jres.trace(name)
            np.testing.assert_allclose(res.trace(name), ref, rtol=0,
                                       atol=1e-9 * np.max(np.abs(ref)))

    def test_validation(self, rng):
        As, bs = _instance(rng, W=4)
        with pytest.raises(ValueError, match="W, m, n"):
            TP.exchange_quadratic(As[0], bs[0], mesh=CPU8)
        with pytest.raises(ValueError, match="bs must be"):
            TP.exchange_quadratic(As, bs[:, :-1], mesh=CPU8)
        with pytest.raises(ValueError, match="xi0"):
            TP.exchange_quadratic(As, bs, T.ADMMConfig(**_KW), mesh=CPU8,
                                  xi0=np.zeros((3, As.shape[2])))
        with pytest.raises(ValueError, match="multiple of the mesh size"):
            TP.exchange_quadratic(rng.standard_normal((12, 8, 4)),
                                  rng.standard_normal((12, 8)), mesh=CPU8)


def _stacked_quad_prox_f(x, z, u, rho, d):
    rhs = d["Atb"] + rho * (z - u)
    y = torch.einsum("wji,wj->wi", d["V"], rhs) / (d["w"] + rho)
    return torch.einsum("wij,wj->wi", d["V"], y)


def _stacked_exchange_prox_g(x, z, u, rho, d):
    y = x + u
    return y - torch.mean(y, dim=0, keepdim=True)


class TestExchangeVariants:
    """Relaxation and fast/accelerated momentum on the exchange runner
    against the port's core engine on the stacked formulation (the
    original's oracle) and against admm_tpu's exchange run."""

    @pytest.mark.parametrize("variant,exact", [
        (dict(relax=1.5), True),
        (dict(fast=True, fasttype="strong", domaxiters=True, maxiters=60), True),
        (dict(fast=True, fasttype="weak"), False),
        (dict(fast=True, fasttype="weak", relax=1.3), False),
    ])
    def test_matches_stacked_engine(self, rng, variant, exact):
        As, bs = _instance(rng, W=4, m=10, n=5)
        W, _, n = As.shape
        G = np.einsum("wmi,wmj->wij", As, As)
        w, V = np.linalg.eigh(G)
        data = {"w": torch.as_tensor(w), "V": torch.as_tensor(V),
                "Atb": torch.as_tensor(np.einsum("wmi,wm->wi", As, bs))}
        cfg = {"maxiters": 400, "abstol": 1e-9, "reltol": 1e-9, **variant}
        eng = T.admm(_stacked_quad_prox_f, _stacked_exchange_prox_g, T.ADMMConfig(**cfg),
                     A=1.0, B=-1.0, c=0.0, shape_x=(W, n), shape_z=(W, n),
                     dtype=torch.float64, data=data, device="cpu")
        exc = TP.exchange_quadratic(As, bs, T.ADMMConfig(**cfg), mesh=CPU8)
        jres = JP.exchange_quadratic(As, bs, J.ADMMConfig(**cfg))
        if exact:
            assert exc.steps == eng.steps
            np.testing.assert_allclose(exc.xopt.numpy(), eng.xopt.numpy(), rtol=1e-8,
                                       atol=1e-10)
            np.testing.assert_allclose(eng.uopt.numpy(), np.broadcast_to(
                exc.uopt.numpy()[None, :], eng.uopt.shape), rtol=1e-8, atol=1e-10)
            assert_same_run(exc, jres)
        else:
            k = min(exc.steps, eng.steps, jres.steps, 50)
            np.testing.assert_allclose(exc.dvals[:k], eng.dvals[:k], rtol=1e-9, atol=1e-12)
            np.testing.assert_allclose(exc.dvals[:k], jres.dvals[:k], rtol=1e-9, atol=1e-12)
            xs, _ = _equilibrium(As, bs)
            np.testing.assert_allclose(exc.xopt.numpy(), xs, atol=1e-5)

    @pytest.mark.parametrize("variant", [
        dict(relax=1.5),
        dict(fast=True, fasttype="strong"),
        dict(fast=True, fasttype="weak"),
    ])
    def test_variants_reach_equilibrium(self, rng, variant):
        As, bs = _instance(rng)
        xs, _ = _equilibrium(As, bs)
        res = TP.exchange_quadratic(As, bs, T.ADMMConfig(**_KW, **variant), mesh=CPU8)
        np.testing.assert_allclose(res.xopt.numpy(), xs, atol=1e-5)
        assert not res.diverged


def _l1_quad_prox(vi, rho, d):
    return soft_threshold((d["c"] + rho * vi) / (1.0 + rho), d["gamma"] / (1.0 + rho))


def _nonneg_quad_prox(vi, rho, d):
    return torch.clamp_min((d["c"] + rho * vi) / (1.0 + rho), 0.0)


def _jl1_quad_prox(vi, rho, d):
    from admm_tpu.ops.prox import soft_threshold as jst

    return jst((d["c"] + rho * vi) / (1.0 + rho), d["gamma"] / (1.0 + rho))


class TestExchangeGeneric:
    def test_nonneg_agents_against_cvx_style_oracle(self, rng):
        W, n = 8, 5
        c = rng.standard_normal((W, n))
        res = TP.exchange_admm(_nonneg_quad_prox, {"c": c}, n, T.ADMMConfig(**_KW), mesh=CPU8,
                               nagents=W)
        x = res.xopt.numpy()
        nu = res.rho_final * res.uopt.numpy()
        assert np.linalg.norm(x.sum(0)) <= 1e-7 and x.min() >= -1e-9
        np.testing.assert_allclose(x, np.maximum(c - nu[None, :], 0.0), atol=1e-6)

    def test_soft_threshold_agents_kkt(self, rng):
        W, n = 8, 6
        c = rng.standard_normal((W, n))
        gamma = 0.3
        res = TP.exchange_admm(_l1_quad_prox, {"c": c, "gamma": gamma}, n, T.ADMMConfig(**_KW),
                               mesh=CPU8)
        assert res.extra["nagents"] == W  # the mesh size
        x = res.xopt.numpy()
        nu = res.rho_final * res.uopt.numpy()
        assert np.linalg.norm(x.sum(0)) <= 1e-7
        ref = soft_threshold(torch.as_tensor(c - nu[None, :]), gamma).numpy()
        np.testing.assert_allclose(x, ref, atol=1e-6)
        jres = JP.exchange_admm(_jl1_quad_prox, {"c": jnp.asarray(c),
                                                 "gamma": jnp.asarray(gamma)},
                                n, J.ADMMConfig(**_KW), nagents=W)
        assert_same_run(res, jres)

    def test_soft_threshold_agents_fast_agrees(self, rng):
        W, n = 8, 6
        c = rng.standard_normal((W, n))
        gamma = 0.3
        res = TP.exchange_admm(_l1_quad_prox, {"c": c, "gamma": gamma}, n,
                               T.ADMMConfig(**_KW, fast=True, fasttype="weak"), mesh=CPU8,
                               nagents=W)
        x = res.xopt.numpy()
        nu = res.rho_final * res.uopt.numpy()
        ref = soft_threshold(torch.as_tensor(c - nu[None, :]), gamma).numpy()
        np.testing.assert_allclose(x, ref, atol=1e-5)
        assert np.linalg.norm(x.sum(0)) <= 1e-5


@pytest.mark.parametrize("variant", [dict(), dict(anderson=5), dict(relax=1.5, unroll=4)])
def test_exchange_on_carried_setup(rng, variant):
    """admm_tpu's per-agent eigh and A^T b carried across with
    convert.exchange_data: the port's iteration on admm_tpu's numbers."""
    As, bs = _instance(rng)
    cfg = {**_KW, "maxiters": 3000, **variant}
    spec = NamedSharding(JP.make_mesh(), PartitionSpec("shards"))
    w, V, Atb = JX._cached_quad_setup(spec)(jnp.asarray(As), jnp.asarray(bs))
    jdata = {"w": w, "V": V, "Atb": Atb}
    jres = JP.exchange_admm(JX._quad_local_prox, jdata, 6, J.ADMMConfig(**cfg))
    data, _ = convert.exchange_data(convert.numpy_state(jdata))
    res = TP.exchange_admm(TX._quad_local_prox, data, 6, T.ADMMConfig(**cfg), mesh=CPU8)
    assert_same_run(res, jres)


def test_fast_weak_steps_follow_the_reduction_order(rng):
    """The weak mode's restarts on one instance: admm_tpu's own step count
    moves with its mesh (one device against eight), and the port's lands
    on the same equilibrium after the same d-value prefix."""
    As, bs = _instance(np.random.default_rng(0))
    cfg = dict(maxiters=2000, abstol=1e-9, reltol=1e-9, fast=True)
    j1 = JP.exchange_quadratic(As, bs, J.ADMMConfig(**cfg), mesh=JP.make_mesh(1))
    j8 = JP.exchange_quadratic(As, bs, J.ADMMConfig(**cfg), mesh=JP.make_mesh(8))
    res = TP.exchange_quadratic(As, bs, T.ADMMConfig(**cfg), mesh=CPU8)
    assert j1.steps != j8.steps  # the restart flags follow the rounding
    k = min(res.steps, j8.steps, 50)
    np.testing.assert_allclose(res.dvals[:k], j8.dvals[:k], rtol=1e-9, atol=1e-12)
    xs, _ = _equilibrium(As, bs)
    for r in (res.xopt.numpy(), np.asarray(j1.xopt), np.asarray(j8.xopt)):
        np.testing.assert_allclose(r, xs, atol=1e-6)
