"""The standard-form SDP of the port (admm_tpu_torch/models/sdp.py) and its
PSD projections (ops/prox.psd_project, ops/matfun.psd_project_ns) against
admm_tpu's on the same numpy inputs in f64: the projections, the dense and
diag solvers with the eigh and Newton-Schulz z-proxes on admm_tpu's setup
carried across (``convert.program_data``, the Gram's Cholesky factor
among it) and on their own, and tests/test_sdp.py's oracles through the
port: the known optimum of ``random_sdp_instance``, the max-cut bound,
the warm start, the registry entry and every validation error of
``make_prox_ops``."""

import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from admm_tpu import ADMMConfig as JaxConfig
from admm_tpu import sdp as jax_sdp
from admm_tpu.engine import Hooks as JaxHooks
from admm_tpu.engine import admm as jax_admm
from admm_tpu.models.sdp import random_sdp_instance as jax_instance
from admm_tpu.ops.matfun import psd_project_ns as jax_psd_project_ns
from admm_tpu.ops.prox import psd_project as jax_psd_project
from admm_tpu_torch import ADMMConfig, Hooks, admm, get_prox_ops, sdp
from admm_tpu_torch.convert import numpy_state, program_data
from admm_tpu_torch.models.sdp import make_prox_ops, random_sdp_instance
from admm_tpu_torch.ops.matfun import psd_project_ns
from admm_tpu_torch.ops.prox import psd_project

from _parity import assert_same_run

torch.set_num_threads(1)
jax_sdp_mod = importlib.import_module("admm_tpu.models.sdp")
sdp_mod = importlib.import_module("admm_tpu_torch.models.sdp")
_CFG = dict(maxiters=20000, abstol=1e-10, reltol=1e-10, unroll=8)
METHODS = {"eigh": {}, "ns": {"prox_method": "ns", "ns_iters": 30},
           "ns_delta": {"prox_method": "ns", "ns_iters": 30, "ns_correct": 1, "ns_delta": 1e-3}}


def _rng(seed=0):
    return np.random.default_rng(seed)


def _kkt_asserts(res, C, A, b, pstar, tol=1e-6):
    # tests/test_sdp.py's KKT checks.
    X, Z, U = res.xopt.numpy(), res.zopt.numpy(), res.uopt.numpy()
    np.testing.assert_allclose(np.einsum("mij,ij->m", A, X), b, atol=1e-6)
    assert np.linalg.eigvalsh(Z).min() >= -1e-8
    assert np.linalg.norm(X - Z) <= 1e-5 * max(1.0, np.linalg.norm(X))
    assert abs(float(np.sum(C * Z)) - pstar) <= tol * max(1.0, abs(pstar))
    S = -res.rho_final * U
    S = 0.5 * (S + S.T)
    assert np.linalg.eigvalsh(S).min() >= -1e-5
    assert abs(np.sum(S * Z)) <= 1e-5 * max(1.0, np.linalg.norm(S) * np.linalg.norm(Z))


def test_random_instance_is_admm_tpus():
    got = random_sdp_instance(10, 12, 4, _rng(3))
    for a, b in zip(got, jax_instance(10, 12, 4, _rng(3))):
        np.testing.assert_array_equal(a, b)
    assert all(a.dtype == np.float32 for a in random_sdp_instance(4, 3, 2, dtype=np.float32))


def test_eigh_projection_matches_dense_oracle_and_jax():
    rng = _rng()
    W = rng.standard_normal((12, 12))
    W = 0.5 * (W + W.T)
    e, Q = np.linalg.eigh(W)
    ref = (Q * np.maximum(e, 0.0)) @ Q.T
    np.testing.assert_allclose(psd_project(torch.from_numpy(W)).numpy(), ref, atol=1e-12)
    # Not symmetric and batched: both packages project the symmetric part.
    Wb = rng.standard_normal((3, 9, 9))
    np.testing.assert_allclose(psd_project(torch.from_numpy(Wb)).numpy(),
                               np.asarray(jax_psd_project(jnp.asarray(Wb))), atol=1e-12)


@pytest.mark.parametrize("small_modes", [False, True])
def test_ns_projection(small_modes):
    # tests/test_sdp.py's two NS regimes: a spectrum bounded away from zero
    # (1e-8 from the exact projection) and near-null modes (absolute error
    # at their scale); the port against admm_tpu's NS to 1e-12 in both.
    rng = _rng()
    Q, _ = np.linalg.qr(rng.standard_normal((16, 16)))
    if small_modes:
        e = np.concatenate([rng.uniform(0.5, 2.0, 7), [1e-4, -1e-4], -rng.uniform(0.5, 2.0, 7)])
    else:
        e = np.concatenate([rng.uniform(0.5, 2.0, 8), -rng.uniform(0.5, 2.0, 8)])
    W = (Q * e) @ Q.T
    ref = (Q * np.maximum(e, 0.0)) @ Q.T
    got = psd_project_ns(torch.from_numpy(W), iters=30).numpy()
    if small_modes:
        assert np.linalg.norm(got - ref) <= 1e-3
    else:
        np.testing.assert_allclose(got, ref, atol=1e-8)
    for kw in ({"iters": 30}, {"iters": 12, "coarse": 4, "correct": 2, "delta": 1e-3}):
        np.testing.assert_allclose(psd_project_ns(torch.from_numpy(W), **kw).numpy(),
                                   np.asarray(jax_psd_project_ns(jnp.asarray(W), **kw)),
                                   rtol=0, atol=1e-12)


def _dense_case(seed=1):
    C, A, b, *_ = random_sdp_instance(8, 10, 3, _rng(seed))
    return C, A, b


def _diag_case(seed=2):
    rng = _rng(seed)
    C = rng.standard_normal((8, 8))
    return 0.5 * (C + C.T), "diag", rng.uniform(0.5, 1.5, 8)


@pytest.mark.parametrize("method", sorted(METHODS))
@pytest.mark.parametrize("form", ["dense", "diag"])
def test_sdp_iteration_on_carried_state(form, method):
    C, A, b = _dense_case() if form == "dense" else _diag_case()
    cfg = dict(maxiters=3000, objevals=True)
    kw = METHODS[method]
    pf, pg, obj, jdata = jax_sdp_mod.make_prox_ops(C, A, b, JaxConfig(**cfg), **kw)
    n = C.shape[0]
    zero = jnp.zeros((n, n))
    jres = jax_admm(pf, pg, JaxConfig(**cfg), A=1.0, B=-1.0, c=0.0, shape_x=(n, n),
                    shape_z=(n, n), x0=zero, z0=zero, u0=zero, hooks=JaxHooks(obj=obj),
                    dtype=jnp.float64, data=jdata)
    state = numpy_state(jdata)
    assert sorted(state) == (["A", "C", "L", "b"] if form == "dense" else ["C", "b"])
    data, _ = program_data(state)
    tpf, tpg, tobj, _ = make_prox_ops(data["C"], A if form == "diag" else data["A"], data["b"],
                                      ADMMConfig(**cfg), **kw)
    if form == "dense":
        # admm_tpu's Gram factor replaces the port's: the iteration alone.
        np.testing.assert_allclose(data["L"].numpy(), np.linalg.cholesky(
            np.einsum("mij,kij->mk", data["A"].numpy(), data["A"].numpy())), atol=1e-12)
    res = admm(tpf, tpg, ADMMConfig(**cfg), A=1.0, B=-1.0, c=0.0, shape_x=(n, n),
               shape_z=(n, n), hooks=Hooks(obj=tobj), dtype=torch.float64, data=data)
    assert 10 < res.steps < 3000
    assert_same_run(res, jres)


VARIANTS = {"plain": {}, "rbadaptive": {"rbadaptive": True}, "unroll": {"unroll": 4},
            "anderson": {"anderson": 5}}


@pytest.mark.parametrize("method", ["eigh", "ns"])
@pytest.mark.parametrize("variant", sorted(VARIANTS))
@pytest.mark.parametrize("form", ["dense", "diag"])
def test_sdp_matches_jax_f64(form, variant, method):
    C, A, b = _dense_case(3) if form == "dense" else _diag_case(4)
    cfg = dict(maxiters=1500, objevals=True, **VARIANTS[variant])
    jres = jax_sdp(C, A, b, config=JaxConfig(**cfg), **METHODS[method])
    res = sdp(C, A, b, config=ADMMConfig(**cfg), device="cpu", **METHODS[method])
    assert res.xopt.shape == (8, 8) and res.xopt.dtype == torch.float64
    if variant == "anderson":
        # AA's window solve amplifies the two LAPACKs' rounding (ROADMAP.md
        # queue 3): the same steps, the iterates to 1e-8.
        assert res.steps == jres.steps
        np.testing.assert_allclose(res.zopt.numpy(), np.asarray(jres.zopt), rtol=0, atol=1e-8)
    else:
        assert_same_run(res, jres)
        np.testing.assert_allclose(res.objopt, jres.objopt, rtol=1e-10)


def test_dense_constraints_reach_known_optimum():
    C, A, b, Xstar, _, _ = random_sdp_instance(10, 12, 4, _rng())
    pstar = float(np.sum(C * Xstar))
    res = sdp(C, A, b, config=ADMMConfig(**_CFG), device="cpu")
    _kkt_asserts(res, C, A, b, pstar)
    np.testing.assert_allclose(res.zopt.numpy(), Xstar, atol=1e-4)


def test_ns_projection_mode():
    C, A, b, Xstar, _, _ = random_sdp_instance(10, 6, 4, _rng())
    pstar = float(np.sum(C * Xstar))
    res = sdp(C, A, b, config=ADMMConfig(maxiters=5000, abstol=1e-8, reltol=1e-8, unroll=8),
              prox_method="ns", ns_iters=40, device="cpu")
    assert abs(float(np.sum(C * res.zopt.numpy())) - pstar) <= 1e-2 * max(1.0, abs(pstar))


def test_diag_constraint_matches_dense_path():
    rng = _rng()
    n = 8
    C = rng.standard_normal((n, n))
    C = 0.5 * (C + C.T)
    b = rng.uniform(0.5, 1.5, n)
    A = np.stack([np.outer(np.eye(n)[i], np.eye(n)[i]) for i in range(n)])
    r_diag = sdp(C, "diag", b, config=ADMMConfig(**_CFG), device="cpu")
    r_dense = sdp(C, A, b, config=ADMMConfig(**_CFG), device="cpu")
    np.testing.assert_allclose(r_diag.zopt.numpy(), r_dense.zopt.numpy(), atol=1e-6)
    np.testing.assert_allclose(np.diagonal(r_diag.xopt.numpy()), b, atol=1e-8)


def test_maxcut_relaxation_bound():
    rng = _rng()
    n = 8
    W = (rng.random((n, n)) < 0.4).astype(float)
    W = np.triu(W, 1)
    W = W + W.T
    L = np.diag(W.sum(1)) - W
    res = sdp(-0.25 * L, "diag", np.ones(n), config=ADMMConfig(**_CFG), device="cpu")
    sdp_val = -float(np.sum(-0.25 * L * res.zopt.numpy()))
    best = max(0.25 * float(s @ L @ s) for k in range(2 ** (n - 1))
               for s in [np.array([1.0] + [1.0 if (k >> i) & 1 else -1.0
                                           for i in range(n - 1)])])
    assert best - 1e-6 <= sdp_val <= 1.5 * best + 1e-6


def test_warm_start_resumes():
    C, A, b, *_ = random_sdp_instance(8, 5, 3, _rng())
    cold = sdp(C, A, b, config=ADMMConfig(**_CFG), device="cpu")
    warm = sdp(C, A, b, config=ADMMConfig(**_CFG), x0=cold.xopt, z0=cold.zopt, u0=cold.uopt,
               device="cpu")
    assert warm.steps <= max(3, cold.steps // 10)
    jwarm = jax_sdp(C, A, b, config=JaxConfig(**_CFG), x0=cold.xopt.numpy(),
                    z0=cold.zopt.numpy(), u0=cold.uopt.numpy())
    # From the optimum the residuals are rounding noise (~1e-10), so the
    # runs are held by steps and iterates, not by their histories.
    assert warm.steps == jwarm.steps
    np.testing.assert_allclose(warm.zopt.numpy(), np.asarray(jwarm.zopt), rtol=0, atol=1e-12)


def test_registry_entry():
    C, A, b, *_ = random_sdp_instance(6, 4, 2, _rng())
    pf, pg, obj = get_prox_ops("sdp", C=C, A=A, b=b, device="cpu")
    X = torch.zeros((6, 6), dtype=torch.float64)
    np.testing.assert_allclose(np.einsum("mij,ij->m", A, pf(X, X, X, 1.0).numpy()), b,
                               atol=1e-8)


_INVALID = {
    "string A": lambda mk: mk(np.eye(4), "diagonal", np.ones(4)),
    "A of another width": lambda mk: mk(np.eye(4), np.zeros((2, 3, 3)), np.ones(2)),
    "A of two dimensions": lambda mk: mk(np.eye(4), np.zeros((4, 4)), np.ones(4)),
    "b of another length": lambda mk: mk(np.eye(4), np.zeros((2, 4, 4)), np.ones(3)),
    "diag b of another length": lambda mk: mk(np.eye(4), "diag", np.ones(3)),
    "C not a matrix": lambda mk: mk(np.ones((2, 4, 4)), "diag", np.ones(4)),
    "prox_method": lambda mk: mk(np.eye(4), "diag", np.ones(4), prox_method="qr"),
    "ns_correct without ns_delta": lambda mk: mk(np.eye(4), "diag", np.ones(4),
                                                 prox_method="ns", ns_correct=2),
    "dependent constraints": lambda mk: mk(np.eye(4), np.stack([_A1, 2.0 * _A1]), np.ones(2)),
}
_A1 = (lambda M: 0.5 * (M + M.T))(_rng(5).standard_normal((4, 4)))


@pytest.mark.parametrize("case", sorted(_INVALID))
def test_make_prox_ops_refuses_what_admm_tpu_refuses(case):
    with pytest.raises(ValueError) as ref:
        _INVALID[case](jax_sdp_mod.make_prox_ops)
    with pytest.raises(ValueError) as port:
        _INVALID[case](lambda *a, **kw: make_prox_ops(*a, device="cpu", **kw))
    assert str(port.value) == str(ref.value)


def test_a_rectangular_c_raises_a_value_error():
    # admm_tpu symmetrizes C before its shape check and raises JAX's
    # TypeError from the transpose; the port checks first.
    with pytest.raises(ValueError, match=r"C must be square, got \(4, 3\)"):
        make_prox_ops(np.ones((4, 3)), "diag", np.ones(3), device="cpu")
    with pytest.raises(TypeError):
        jax_sdp_mod.make_prox_ops(np.ones((4, 3)), "diag", np.ones(3))


def test_sdp_requires_its_operands():
    for args in ((None,), (np.eye(4), None, np.ones(4)), (np.eye(4), "diag", None)):
        with pytest.raises(ValueError, match="requires C, A, b"):
            sdp(*args, device="cpu")
