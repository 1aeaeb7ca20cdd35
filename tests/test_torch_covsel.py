"""Covariance selection of the port (admm_tpu_torch/models/covarianceselection.py)
and its matrix functions (ops/matfun.py, ops/prox.covsel_eig_prox) against
admm_tpu's on the same numpy inputs in f64: the Newton-Schulz square root
batched and unbatched, both x-proxes on a W that is symmetric only up to
rounding (torch's eigh reads one triangle, JAX's symmetrizes first), the
solver in eigh, ns and ns_fast on admm_tpu's setup carried across
(``convert.program_data``) and on its own, and the reference's oracles
(tests/test_covarianceselection.py) through the port."""

import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from admm_tpu import ADMMConfig as JaxConfig
from admm_tpu import covarianceselection as jax_covsel
from admm_tpu.engine import Hooks as JaxHooks
from admm_tpu.engine import admm as jax_admm
from admm_tpu.ops import matfun as jax_matfun
from admm_tpu.ops import prox as jax_prox
from admm_tpu_torch import ADMMConfig, Hooks, admm, covarianceselection
from admm_tpu_torch.convert import numpy_state, program_data
from admm_tpu_torch.ops import matfun, prox

from _parity import assert_same_run

torch.set_num_threads(1)
jax_cs_mod = importlib.import_module("admm_tpu.models.covarianceselection")
cs_mod = importlib.import_module("admm_tpu_torch.models.covarianceselection")

METHODS = {"eigh": {}, "ns": {"prox_method": "ns"}, "ns_fast": {"prox_method": "ns_fast"},
           "ns_14": {"prox_method": "ns", "ns_iters": 14, "ns_correct": 1}}


def _make_instance(seed, rows, cols):
    # tests/test_covarianceselection.py's generator
    # (testers/covarianceselectiontest.m:112-154).
    rng = np.random.default_rng(seed)
    Sinv = np.diag(np.ones(cols))
    k = int(np.ceil(0.001 * cols * cols)) + 2
    idx = rng.choice(cols * cols, size=k, replace=False)
    Sinv.flat[idx] = 1.0
    Sinv = Sinv + Sinv.T
    w = np.linalg.eigvalsh(Sinv)
    if w.min() < 0:
        Sinv = Sinv + 1.1 * abs(w.min()) * np.eye(cols)
    S = np.linalg.inv(Sinv)
    return rng.multivariate_normal(np.zeros(cols), S, size=rows), Sinv


def _obj(S, X, Z, lam):
    return np.trace(S @ X) - np.linalg.slogdet(X)[1] + lam * np.sum(np.abs(Z))


def _nearly_symmetric(seed, n, scale):
    # Symmetric, then the upper triangle nudged: the x-prox's W is symmetric
    # only up to the rounding of a Q diag Q^T reconstruction.  The nudge
    # (1e-8 relative) is larger than rounding, so that decomposing one
    # triangle instead of the symmetric part shows far above the bars.
    rng = np.random.default_rng(seed)
    M = rng.standard_normal((n, n)) * scale
    W = (M + M.T) / 2
    return W + np.triu(rng.standard_normal((n, n)), 1) * 1e-8 * scale


@pytest.mark.parametrize("n,scale", [(16, 1.0), (64, 10.0), (96, 100.0)])
def test_ns_sqrtm_matches_eigh_sqrt_and_jax(n, scale):
    rng = np.random.default_rng(7)
    M = rng.standard_normal((n, n))
    W = (M + M.T) / 2 * scale
    A = W @ W + 4.0 * np.eye(n)  # SPD, kappa up to ~1e6 at scale 100
    e, Q = np.linalg.eigh(A)
    ref = (Q * np.sqrt(e)) @ Q.T
    got = matfun.ns_sqrtm(torch.from_numpy(A)).numpy()
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-9 * np.linalg.norm(ref))
    np.testing.assert_allclose(got, np.asarray(jax_matfun.ns_sqrtm(jnp.asarray(A))), rtol=0,
                               atol=1e-12 * np.linalg.norm(ref))


@pytest.mark.parametrize("coarse,correct", [(0, 0), (20, 2), (5, 1)])
def test_ns_sqrtm_batched_matches_jax(coarse, correct):
    rng = np.random.default_rng(8)
    M = rng.standard_normal((3, 24, 24))
    A = M @ np.swapaxes(M, -1, -2) + 0.5 * np.eye(24)
    got = matfun.ns_sqrtm(torch.from_numpy(A), 20, coarse, correct).numpy()
    want = np.asarray(jax_matfun.ns_sqrtm(jnp.asarray(A), 20, coarse, correct))
    for i in range(3):
        e, Q = np.linalg.eigh(A[i])
        ref = (Q * np.sqrt(e)) @ Q.T
        np.testing.assert_allclose(got[i], ref, atol=1e-10 * np.linalg.norm(ref))
        # The batch and one matrix alone agree.
        np.testing.assert_allclose(
            matfun.ns_sqrtm(torch.from_numpy(A[i]), 20, coarse, correct).numpy(), got[i],
            rtol=0, atol=1e-13 * np.linalg.norm(ref))
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-12 * np.linalg.norm(want))


def test_spectral_upper_bound_matches_jax():
    rng = np.random.default_rng(3)
    A = rng.standard_normal((4, 10, 10))
    A = A @ np.swapaxes(A, -1, -2)
    got = matfun._spectral_upper_bound(torch.from_numpy(A)).numpy()
    np.testing.assert_allclose(got, np.asarray(jax_matfun._spectral_upper_bound(A)), rtol=1e-14)
    assert np.all(got >= np.linalg.eigvalsh(A)[:, -1])


@pytest.mark.parametrize("rho", [0.1, 1.0, 10.0])
def test_covsel_proxes_on_a_nearly_symmetric_w(rho):
    # Trap 1: torch.linalg.eigh reads the lower triangle, jnp.linalg.eigh
    # symmetrizes first; the port symmetrizes W itself.  The NS prox works
    # on W as it is, in both packages.
    W = _nearly_symmetric(9, 48, 10.0)
    tW = torch.from_numpy(W)
    ref = np.asarray(jax_prox.covsel_eig_prox(jnp.asarray(W), rho))
    got = prox.covsel_eig_prox(tW, rho).numpy()
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-12 * np.linalg.norm(ref))
    np.testing.assert_allclose(prox.covsel_eig_prox(tW, rho, weight=0.25).numpy(),
                               np.asarray(jax_prox.covsel_eig_prox(jnp.asarray(W), rho, 0.25)),
                               rtol=0, atol=1e-12 * np.linalg.norm(ref))
    ns = matfun.covsel_ns_prox(tW, rho).numpy()
    np.testing.assert_allclose(ns, np.asarray(jax_matfun.covsel_ns_prox(jnp.asarray(W), rho)),
                               rtol=0, atol=1e-12 * np.linalg.norm(ref))
    Ws = (W + W.T) / 2
    np.testing.assert_allclose(matfun.covsel_ns_prox(torch.from_numpy(Ws), rho).numpy(), ref,
                               atol=1e-9 * np.linalg.norm(ref))
    # The spectral function solves rho X - X^{-1} = W.
    np.testing.assert_allclose(rho * got - np.linalg.inv(got), Ws, atol=1e-9 * np.linalg.norm(W))


def test_eigh_of_one_triangle_is_what_symmetrizing_prevents():
    # Without the symmetrization the port would decompose another matrix:
    # the lower triangle's, which differs from the symmetric part by the
    # nudge.
    W = _nearly_symmetric(10, 32, 1.0)
    e_low = torch.linalg.eigvalsh(torch.from_numpy(W)).numpy()
    e_sym = np.linalg.eigvalsh((W + W.T) / 2)
    np.testing.assert_allclose(e_low, np.linalg.eigvalsh(np.tril(W) + np.tril(W, -1).T),
                               atol=1e-13)
    assert np.max(np.abs(e_low - e_sym)) > 1e-10


@pytest.mark.parametrize("method", sorted(METHODS))
def test_covsel_iteration_on_carried_state(method):
    D, _ = _make_instance(3, 200, 20)
    kw = METHODS[method]
    cfg = dict(maxiters=400, objevals=True)
    S = np.asarray(jax_cs_mod.empirical_covariance(D))
    pf, pg, obj, jdata = jax_cs_mod.make_prox_ops(S, 0.5, JaxConfig(**cfg), **kw)
    n = S.shape[0]
    zero = jnp.zeros((n, n))
    jres = jax_admm(pf, pg, JaxConfig(**cfg), A=1.0, B=-1.0, c=0.0, shape_x=(n, n),
                    shape_z=(n, n), x0=zero, z0=zero, u0=zero, hooks=JaxHooks(obj=obj),
                    dtype=jnp.float64, data=jdata)
    state = numpy_state(jdata)
    assert sorted(state) == ["S", "lam"]
    data, _ = program_data(state)
    tpf, tpg, tobj, _ = cs_mod.make_prox_ops(data["S"], 0.5, ADMMConfig(**cfg), **kw)
    res = admm(tpf, tpg, ADMMConfig(**cfg), A=1.0, B=-1.0, c=0.0, shape_x=(n, n),
               shape_z=(n, n), hooks=Hooks(obj=tobj), dtype=torch.float64, data=data)
    assert 10 < res.steps < 400
    assert_same_run(res, jres)


VARIANTS = {"plain": {}, "convtest": {"convtest": True}, "rbadaptive": {"rbadaptive": True},
            "unroll": {"unroll": 3}}


@pytest.mark.parametrize("method", ["eigh", "ns", "ns_fast"])
@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_covsel_matches_jax_f64(method, variant):
    rng = np.random.default_rng(4)
    D = rng.standard_normal((160, 24))
    cfg = dict(maxiters=400, objevals=True, **VARIANTS[variant])
    jres = jax_covsel(D, 0.3, JaxConfig(**cfg), **METHODS[method])
    res = covarianceselection(D, 0.3, ADMMConfig(**cfg), device="cpu", **METHODS[method])
    assert res.xopt.shape == (24, 24) and res.xopt.dtype == torch.float64
    assert_same_run(res, jres)
    np.testing.assert_allclose(res.objopt, jres.objopt, rtol=1e-10)


def test_covsel_beats_truth_objective():
    # tests/test_covarianceselection.py::test_covsel_beats_truth_objective.
    lam = 1.0
    D, Sinv = _make_instance(0, 256, 32)
    S = cs_mod.empirical_covariance(torch.from_numpy(D)).numpy()
    np.testing.assert_allclose(S, np.asarray(jax_cs_mod.empirical_covariance(D)), rtol=1e-13)
    res = covarianceselection(D, lam, ADMMConfig(objevals=True, maxiters=1000, convtest=True),
                              device="cpu")
    assert not res.diverged
    X = res.xopt.numpy()
    assert X.shape == (32, 32)
    assert _obj(S, X, X, lam) < _obj(S, Sinv, Sinv, lam)
    np.testing.assert_allclose(X, X.T, atol=1e-8)
    assert np.linalg.eigvalsh(X).min() > 0


def test_covsel_solver_ns_matches_eigh():
    # tests/test_covarianceselection.py::test_covsel_solver_ns_matches_eigh
    # and test_ns_fast_mode_matches_eigh.
    D, _ = _make_instance(3, 256, 24)
    cfg = ADMMConfig(maxiters=400, convtest=True)
    res_eig = covarianceselection(D, 1.0, cfg, device="cpu")
    res_ns = covarianceselection(D, 1.0, cfg, prox_method="ns", device="cpu")
    assert not res_ns.diverged and res_ns.steps == res_eig.steps
    np.testing.assert_allclose(res_ns.xopt.numpy(), res_eig.xopt.numpy(), atol=1e-7)
    D = np.random.default_rng(4).standard_normal((160, 24))
    r_e = covarianceselection(D, 0.3, ADMMConfig(maxiters=400), device="cpu")
    r_f = covarianceselection(D, 0.3, ADMMConfig(maxiters=400), prox_method="ns_fast",
                              device="cpu")
    np.testing.assert_allclose(r_f.xopt.numpy(), r_e.xopt.numpy(), rtol=1e-6, atol=1e-8)
    with pytest.raises(ValueError, match="prox_method") as port:
        covarianceselection(D, 0.3, prox_method="bogus", device="cpu")
    with pytest.raises(ValueError) as ref:
        jax_covsel(D, 0.3, prox_method="bogus")
    assert str(port.value) == str(ref.value)
    # The zero-argument demo runs its tester on the card by default; where
    # no card is visible it raises the placement error naming device="cpu"
    # (the CPU demo: tests/test_torch_demo_mode.py).
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match='device="cpu"'):
            covarianceselection()


def test_ns_fast_pins_coarse_and_correct():
    # ns_fast: every square-root step coarse, at least 2 corrections.
    S = torch.eye(4, dtype=torch.float64)
    for correct, want in ((0, 2), (3, 3)):
        pf, *_ = cs_mod.make_prox_ops(S, 0.1, prox_method="ns_fast", ns_iters=9,
                                      ns_correct=correct)
        assert pf.keywords == {"iters": 9, "coarse": 9, "correct": want}


def test_covsel_warm_start_and_tensor_inputs():
    # A warm start from the solution reconverges at once; CPU tensors ask
    # for the CPU and keep their dtype.
    D = torch.from_numpy(np.random.default_rng(5).standard_normal((120, 12)))
    cfg = ADMMConfig(maxiters=400)
    cold = covarianceselection(D, 0.2, cfg)
    assert cold.xopt.device.type == "cpu" and cold.xopt.dtype == torch.float64
    warm = covarianceselection(D, 0.2, cfg, x0=cold.xopt, z0=cold.zopt, u0=cold.uopt)
    assert warm.steps <= max(3, cold.steps // 10)
    jwarm = jax_covsel(D.numpy(), 0.2, JaxConfig(maxiters=400), x0=cold.xopt.numpy(),
                       z0=cold.zopt.numpy(), u0=cold.uopt.numpy())
    assert_same_run(warm, jwarm)
