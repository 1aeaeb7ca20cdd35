"""The LP and QP of the port (admm_tpu_torch/models/linearprogram.py,
quadraticprogram.py) with their KKT solvers (ops/solve.py) and Ruiz
scaling (ops/scaling.py) against admm_tpu's on the same numpy inputs in
f64: on admm_tpu's setup carried across (``convert.program_data``, the KKT
solvers field by field) to isolate the iteration, and with each package
doing its own setup (eigh of P, the Schur Cholesky, the affine fold); the
reference's oracles (tests/test_linearprogram.py,
tests/test_quadraticprogram.py), tests/test_precondition.py and
tests/test_illconditioned.py run through the port; and the port's own
refusal of a None constraint operand (ADVICE.md:5)."""

import importlib
import warnings

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from admm_tpu import ADMMConfig as JaxConfig
from admm_tpu import lasso as jax_lasso
from admm_tpu import linearprogram as jax_lp
from admm_tpu import quadraticprogram as jax_qp
from admm_tpu.engine import Hooks as JaxHooks
from admm_tpu.engine import admm as jax_admm
from admm_tpu.ops import scaling as jax_scaling
from admm_tpu.ops import solve as jax_solve
from admm_tpu_torch import ADMMConfig, Hooks, admm, lasso, linearprogram, quadraticprogram
from admm_tpu_torch.convert import numpy_state, program_data
from admm_tpu_torch.ops import scaling, solve

from _parity import assert_same_run

torch.set_num_threads(1)
jax_lp_mod = importlib.import_module("admm_tpu.models.linearprogram")
jax_qp_mod = importlib.import_module("admm_tpu.models.quadraticprogram")
lp_mod = importlib.import_module("admm_tpu_torch.models.linearprogram")
qp_mod = importlib.import_module("admm_tpu_torch.models.quadraticprogram")

# The KKT paths: the affine fold, the factored apply, the dynamic-rho Schur
# solve (one Cholesky a step), the affine fold unrolled (sub-steps past the
# stop frozen) and relaxed.
VARIANTS = {"affine": ({}, "affine"), "chol": ({}, "chol"),
            "rbadaptive": ({"rbadaptive": True}, "affine"),
            "relax": ({"relax": 1.5}, "chol"),
            "unroll": ({"unroll": 3}, "affine")}


def _lp_instance(seed=42, m=24, n=48):
    # tests/test_linearprogram.py::test_lp_qp_affine_kkt_matches_chol's
    # shape: all-positive fat D, nonnegative planted x.
    rng = np.random.default_rng(seed)
    truex = np.abs(rng.standard_normal(n))
    D = np.abs(rng.standard_normal((m, n)))
    return rng.random(n) + 0.5, D, D @ truex


def _spd(rng, n):
    P0 = rng.standard_normal((n, n))
    return P0 @ P0.T + n * np.eye(n)


def _qp_bounded_instance(seed=2, n=32):
    # Active bounds: a well-conditioned P and a large q push about half of
    # the unconstrained minimizer out of the box.
    rng = np.random.default_rng(seed)
    P = _spd(rng, n) / n
    return P, 3.0 * rng.standard_normal(n), -0.5 * np.ones(n), 0.5 * np.ones(n)


def _jax_run(pf, pg, obj, data, cfg, n):
    return jax_admm(pf, pg, cfg, A=1.0, B=-1.0, c=0.0, m=n, nA=n, nB=n,
                    hooks=JaxHooks(obj=obj), dtype=jnp.float64, data=data)


def _port_run(pf, pg, obj, data, cfg, n):
    return admm(pf, pg, cfg, A=1.0, B=-1.0, c=0.0, m=n, nA=n, nB=n, hooks=Hooks(obj=obj),
                dtype=torch.float64, data=data)


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_lp_iteration_on_carried_state(variant):
    b, D, s = _lp_instance()
    n = D.shape[1]
    kw, mode = VARIANTS[variant]
    cfg = dict(maxiters=3000, objevals=True, **kw)
    pf, pg, obj, jdata = jax_lp_mod.make_prox_ops(b, D, s, JaxConfig(**cfg), kkt_mode=mode)
    jres = _jax_run(pf, pg, obj, jdata, JaxConfig(**cfg), n)
    state = numpy_state(jdata)
    kkt = {"affine": ["kkt.K1", "kkt.x0"], "chol": ["kkt.D", "kkt.Minv", "kkt.MinvDt", "kkt.cf",
                                                    "kkt.lower"]}
    dynamic = JaxConfig(**cfg).dynamic_rho
    # The LP's Schur solve keeps V = None: no kkt.V crosses.
    assert sorted(state) == sorted(["b", "s"] + (["kkt.D", "kkt.G", "kkt.w"] if dynamic
                                                 else kkt[mode]))
    data, warm = program_data(state)
    assert warm == {} and data["b"].dtype == torch.float64
    res = _port_run(lp_mod._prox_f, lp_mod._prox_g, lp_mod._obj, data, ADMMConfig(**cfg), n)
    assert 10 < res.steps < 3000
    assert_same_run(res, jres)


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_lp_matches_jax_f64(variant):
    # Each package factors on its own (the affine fold, the Schur
    # Cholesky) in f64; the runs agree to ~1e-15 relative.
    b, D, s = _lp_instance(0, 30, 64)
    kw, mode = VARIANTS[variant]
    cfg = dict(maxiters=3000, objevals=True, **kw)
    jres = jax_lp(b, D, s, JaxConfig(**cfg), kkt_mode=mode)
    res = linearprogram(b, D, s, ADMMConfig(**cfg), kkt_mode=mode, device="cpu")
    assert res.xopt.dtype == torch.float64 and res.xopt.device.type == "cpu"
    assert_same_run(res, jres)
    np.testing.assert_allclose(res.objopt, jres.objopt, rtol=1e-10)


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_qp_standard_iteration_on_carried_state(variant):
    b, D, s = _lp_instance(7, 20, 40)
    rng = np.random.default_rng(8)
    n = D.shape[1]
    P, q = _spd(rng, n), rng.standard_normal(n)
    kw, mode = VARIANTS[variant]
    cfg = dict(maxiters=3000, objevals=True, **kw)
    pf, pg, jdata = jax_qp_mod.make_prox_ops_standard(P, q, D, s, JaxConfig(**cfg),
                                                      kkt_mode=mode)
    jdata.update(P=jnp.asarray(P), r=jnp.asarray(0.7))
    jres = _jax_run(pf, pg, jax_qp_mod._obj, jdata, JaxConfig(**cfg), n)
    state = numpy_state(jdata)
    if JaxConfig(**cfg).dynamic_rho:
        assert {"kkt.D", "kkt.V", "kkt.w", "kkt.G"} <= set(state)
    data, _ = program_data(state)
    res = _port_run(qp_mod._prox_f_standard, qp_mod._prox_g_standard, qp_mod._obj, data,
                    ADMMConfig(**cfg), n)
    assert 10 < res.steps < 3000
    assert_same_run(res, jres)


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_qp_standard_matches_jax_f64(variant):
    b, D, s = _lp_instance(3, 24, 48)
    rng = np.random.default_rng(4)
    P, q = _spd(rng, 48), rng.standard_normal(48)
    kw, mode = VARIANTS[variant]
    cfg = dict(maxiters=3000, objevals=True, **kw)
    jres = jax_qp(P, q, 0.25, D, s, JaxConfig(**cfg), kkt_mode=mode)
    res = quadraticprogram(P, q, 0.25, D, s, ADMMConfig(**cfg), kkt_mode=mode, device="cpu")
    assert_same_run(res, jres)
    np.testing.assert_allclose(res.objopt, jres.objopt, rtol=1e-10)


BOUNDED = {"static": {}, "rbadaptive": {"rbadaptive": True}, "unroll": {"unroll": 4},
           "relax": {"relax": 1.6}}


@pytest.mark.parametrize("variant", sorted(BOUNDED))
def test_qp_bounded_iteration_on_carried_state(variant):
    P, q, lb, ub = _qp_bounded_instance()
    n = P.shape[0]
    cfg = dict(maxiters=3000, objevals=True, **BOUNDED[variant])
    pf, pg, jdata = jax_qp_mod.make_prox_ops_bounded(P, q, lb, ub, JaxConfig(**cfg))
    jdata.update(P=jnp.asarray(P), r=jnp.asarray(-1.5))
    jres = _jax_run(pf, pg, jax_qp_mod._obj, jdata, JaxConfig(**cfg), n)
    state = numpy_state(jdata)
    dynamic = JaxConfig(**cfg).dynamic_rho
    assert sorted(state) == sorted(["P", "lb", "q", "r", "ub"]
                                   + (["sol.V", "sol.w"] if dynamic else ["Minv"]))
    data, _ = program_data(state)
    pf = qp_mod._prox_f_bounded_adaptive if dynamic else qp_mod._prox_f_bounded_static
    res = _port_run(pf, qp_mod._prox_g_bounded, qp_mod._obj, data, ADMMConfig(**cfg), n)
    assert 10 < res.steps < 3000
    assert_same_run(res, jres)
    # About half of the box is active at the optimum.
    assert 4 < int(np.sum(np.abs(res.xopt.numpy()) > 0.5 - 1e-6)) < n - 4


@pytest.mark.parametrize("variant", sorted(BOUNDED))
def test_qp_bounded_matches_jax_f64(variant):
    P, q, lb, ub = _qp_bounded_instance(5, 40)
    cfg = dict(maxiters=3000, objevals=True, **BOUNDED[variant])
    jres = jax_qp(P, q, 1.0, lb, ub, JaxConfig(**cfg))
    res = quadraticprogram(P, q, 1.0, lb, ub, ADMMConfig(**cfg), device="cpu")
    assert_same_run(res, jres)
    np.testing.assert_allclose(res.objopt, jres.objopt, rtol=1e-10)


@pytest.mark.parametrize("rho", [0.3, 1.0, 2.7])
@pytest.mark.parametrize("with_p", [False, True])
def test_kkt_solvers_match_jax_and_the_kkt_system(rho, with_p):
    rng = np.random.default_rng(11)
    m, n = 12, 30
    D = rng.standard_normal((m, n))
    P = _spd(rng, n) if with_p else None
    b1, b2 = rng.standard_normal(n), rng.standard_normal(m)
    j = jax_solve.kkt_eq_solver.from_matrices(jnp.asarray(D),
                                              None if P is None else jnp.asarray(P))
    t = solve.kkt_eq_solver.from_matrices(torch.from_numpy(D),
                                          None if P is None else torch.from_numpy(P))
    assert (t.V is None) == (j.V is None)
    tb1, tb2 = torch.from_numpy(b1), torch.from_numpy(b2)
    want = np.asarray(j.solve(jnp.asarray(b1), jnp.asarray(b2), rho))
    for got in (t.solve(tb1, tb2, rho), t.materialize(rho).solve(tb1, tb2),
                t.materialize_affine(rho, tb2).solve(tb1)):
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-9, atol=1e-11)
    # x solves the KKT system [[P + rho I, D^T], [D, 0]] [x; y] = [b1; b2].
    Pm = np.zeros((n, n)) if P is None else P
    K = np.block([[Pm + rho * np.eye(n), D.T], [D, np.zeros((m, m))]])
    np.testing.assert_allclose(want, np.linalg.solve(K, np.r_[b1, b2])[:n], rtol=1e-9,
                               atol=1e-11)
    K1, W = t.materialize_affine_map(rho)
    jK1, jW = j.materialize_affine_map(rho)
    np.testing.assert_allclose(K1.numpy(), np.asarray(jK1), atol=1e-12)
    np.testing.assert_allclose(W.numpy(), np.asarray(jW), atol=1e-12)
    assert torch.equal(K1, K1.T)


def test_cho_factor_turns_a_failed_factor_into_nans():
    # jax.scipy.linalg.cho_factor fails silently in NaNs; so does the
    # port's, without reading the factorization's info on the host.
    S = torch.tensor([[1.0, 2.0], [2.0, 1.0]], dtype=torch.float64)
    F, lower = solve.cho_factor(S)
    assert lower and torch.isnan(F).all()
    F, lower = solve.cho_factor(S @ S.T + torch.eye(2, dtype=torch.float64), lower=False)
    assert not lower and torch.equal(F, torch.triu(F))
    b = torch.tensor([1.0, -2.0], dtype=torch.float64)
    np.testing.assert_allclose(solve.cho_solve((F, lower), b).numpy(),
                               np.linalg.solve((S @ S.T).numpy() + np.eye(2), b.numpy()))


def test_lp_unique_feasible_point():
    # tests/test_linearprogram.py::test_lp_unique_feasible_point.
    rng = np.random.default_rng(0)
    n = 64
    b = rng.random(n) + 0.5
    truex = np.abs(rng.standard_normal(n))
    D = np.abs(rng.standard_normal((n, n)))
    s = D @ truex
    res = linearprogram(b, D, s, ADMMConfig(objevals=True, maxiters=10000, abstol=1e-11,
                                            reltol=1e-9), device="cpu")
    xopt = res.xopt.numpy()
    assert abs((b @ truex - b @ xopt) / (b @ xopt)) <= 1e-6
    Dx = D @ xopt
    assert np.mean(np.abs((Dx - s) / Dx)) <= 1e-6


def test_lp_qp_affine_kkt_matches_chol():
    # tests/test_linearprogram.py::test_lp_qp_affine_kkt_matches_chol.
    b, D, s = _lp_instance(42, 48, 96)
    rng = np.random.default_rng(43)
    n = 96
    cfg = ADMMConfig(maxiters=20000, unroll=16)
    r_aff = linearprogram(b, D, s, cfg, device="cpu")
    r_chol = linearprogram(b, D, s, cfg, kkt_mode="chol", device="cpu")
    assert r_aff.steps == r_chol.steps
    xa, xc = r_aff.xopt.numpy(), r_chol.xopt.numpy()
    np.testing.assert_allclose(xa, xc, atol=1e-12 * np.linalg.norm(xc))
    assert np.linalg.norm(D @ xa - s) / np.linalg.norm(s) < 1e-12
    P, q = _spd(rng, n), rng.standard_normal(n)
    r_aff = quadraticprogram(P, q, 0.0, D, s, cfg, device="cpu")
    r_chol = quadraticprogram(P, q, 0.0, D, s, cfg, kkt_mode="chol", device="cpu")
    assert r_aff.steps == r_chol.steps
    np.testing.assert_allclose(r_aff.xopt.numpy(), r_chol.xopt.numpy(),
                               atol=1e-12 * np.linalg.norm(r_chol.xopt.numpy()))
    with pytest.raises(ValueError, match="kkt_mode") as port:
        linearprogram(b, D, s, cfg, kkt_mode="bogus", device="cpu")
    with pytest.raises(ValueError) as ref:
        jax_lp(b, D, s, JaxConfig(maxiters=10), kkt_mode="bogus")
    assert str(port.value) == str(ref.value)
    with pytest.raises(ValueError, match="kkt_mode"):
        quadraticprogram(P, q, 0.0, D, s, cfg, kkt_mode="bogus", device="cpu")


def _box_g(x, z, u, rho, d):
    return torch.clamp(x + u, 0.0, 0.3)


def _jax_box_g(x, z, u, rho, d):
    return jnp.clip(x + u, 0.0, 0.3)


@pytest.mark.parametrize("family", ["lp", "qp_standard", "qp_bounded"])
def test_altproxg_replaces_the_z_prox(family):
    # The reference's args.altproxg (linearprogram.m:162-171,
    # getProxOps.m:664-666): a box that binds, so its runs differ from the
    # default prox's, in both packages alike.
    b, D, s = _lp_instance(5, 16, 32)
    rng = np.random.default_rng(6)
    P, q = _spd(rng, 32), rng.standard_normal(32)
    cfg = dict(maxiters=2000, objevals=True)
    if family == "lp":
        run = lambda fn, g, C, **kw: fn(b, D, s, C(**cfg), altproxg=g, **kw)  # noqa: E731
        ports, refs = (linearprogram, jax_lp)
    else:
        c1, c2 = (D, s) if family == "qp_standard" else (-np.ones(32), np.ones(32))
        run = lambda fn, g, C, **kw: fn(P, q, 0.0, c1, c2, C(**cfg), altproxg=g,  # noqa: E731
                                        **kw)
        ports, refs = (quadraticprogram, jax_qp)
    res = run(ports, _box_g, ADMMConfig, device="cpu")
    jres = run(refs, _jax_box_g, JaxConfig)
    assert_same_run(res, jres)
    z = res.zopt.numpy()
    assert z.min() >= 0.0 and z.max() <= 0.3
    plain = run(ports, None, ADMMConfig, device="cpu")
    assert np.max(np.abs(plain.zopt.numpy() - z)) > 1e-3


def test_qp_bound_normalization():
    # tests/test_quadraticprogram.py::test_qp_bound_normalization, and
    # against admm_tpu's run.
    rng = np.random.default_rng(3)
    n = 16
    d = 1.0 + rng.random(n)
    q = rng.standard_normal(n) * 3.0
    lb, ub = -np.ones(n), np.ones(n)
    cfg = ADMMConfig(maxiters=5000)
    r1 = quadraticprogram(np.diag(d), q, 0.0, lb, ub, cfg, device="cpu")
    r2 = quadraticprogram(np.diag(d), q, 0.0, ub, lb, cfg, device="cpu")
    np.testing.assert_allclose(r1.xopt.numpy(), r2.xopt.numpy(), atol=1e-10)
    assert_same_run(r2, jax_qp(np.diag(d), q, 0.0, ub, lb, JaxConfig(maxiters=5000)))


def _wellcond_P(rng, n):
    # tests/test_quadraticprogram.py's generator (quadraticprogramtest.m:135-138).
    P = rng.random((n, n))
    P = P + P.T
    w = 1.0 + rng.random(n)
    Q = np.linalg.eigh(P + P.T)[1]
    return (Q * w) @ Q.T


def test_qp_standard_unique_feasible_point():
    rng = np.random.default_rng(0)
    n = 48
    P = _wellcond_P(rng, n)
    q = rng.standard_normal(n)
    r = float(rng.standard_normal())
    truex = np.abs(rng.standard_normal(n))
    D = np.abs(rng.standard_normal((n, n)))
    s = D @ truex
    res = quadraticprogram(P, q, r, D, s, ADMMConfig(objevals=True, maxiters=10000,
                                                     abstol=1e-11, reltol=1e-9), device="cpu")
    np.testing.assert_allclose(res.xopt.numpy(), truex, atol=1e-5)
    assert np.linalg.norm(D @ res.xopt.numpy() - s) <= 1e-5


@pytest.mark.parametrize("case", ["interior", "active_diagonal"])
def test_qp_bounded_oracles(case):
    # tests/test_quadraticprogram.py's bounded-form oracles.
    if case == "interior":
        rng = np.random.default_rng(1)
        n = 48
        P = _wellcond_P(rng, n)
        q = rng.standard_normal(n)
        xstar = -np.linalg.solve(P, q)
        lb, ub = xstar - 1.0 - rng.random(n), xstar + 1.0 + rng.random(n)
        maxiters, atol = 10000, 1e-6
    else:
        rng = np.random.default_rng(2)
        n = 32
        d = 1.0 + rng.random(n)
        P, q = np.diag(d), rng.standard_normal(n) * 3.0
        lb, ub = -0.5 * np.ones(n), 0.5 * np.ones(n)
        xstar = np.clip(-q / d, lb, ub)
        maxiters, atol = 20000, 1e-5
    res = quadraticprogram(P, q, 0.0, lb, ub, ADMMConfig(maxiters=maxiters, abstol=1e-11,
                                                         reltol=1e-9, unroll=16),
                           device="cpu")
    np.testing.assert_allclose(res.xopt.numpy(), xstar, atol=atol)


def test_qp_refuses_a_missing_constraint_operand():
    # ADVICE.md:5: admm_tpu's precondition=True turns a None into NaN bounds
    # and returns a run that diverged at its first step; the port names the
    # argument up front, with or without preconditioning.
    rng = np.random.default_rng(0)
    P, q = _spd(rng, 8), rng.standard_normal(8)
    for cons1, cons2, name in ((None, np.ones(8), "cons1"), (-np.ones(8), None, "cons2"),
                               (None, None, "cons1")):
        for precondition in (True, False):
            with pytest.raises(ValueError, match=f"{name} is None"):
                quadraticprogram(P, q, 0.0, cons1, cons2, precondition=precondition,
                                 device="cpu")
    assert jax_qp(P, q, 0.0, None, np.ones(8), precondition=True).diverged


# ---- tests/test_precondition.py through the port -------------------------

def _bad_scales(rng, m, n, spread=2.0):
    G = 10.0 ** rng.uniform(-spread, spread, m)
    F = 10.0 ** rng.uniform(-spread, spread, n)
    return G, F


def _pc_lp_instance(rng, m=40, n=120):
    D = rng.standard_normal((m, n))
    xt = np.abs(rng.standard_normal(n))
    return np.abs(rng.standard_normal(n)) + 0.1, D, D @ xt


TIGHT = dict(abstol=1e-8, reltol=1e-8, maxiters=60000, unroll=16)


def test_ruiz_equilibrates_kkt():
    rng = np.random.default_rng(0)
    m, n = 40, 90
    G, F = _bad_scales(rng, m, n, 3.0)
    D = G[:, None] * rng.standard_normal((m, n)) * F[None, :]
    P = rng.standard_normal((n, n))
    P = F[:, None] * (P @ P.T + np.eye(n)) * F[None, :]
    e, r = scaling.ruiz_equilibrate(D, P)
    je, jr = jax_scaling.ruiz_equilibrate(D, P)
    np.testing.assert_array_equal(e, je)
    np.testing.assert_array_equal(r, jr)
    assert scaling.kkt_scale_quality(D, P) > 1e3
    after = scaling.kkt_scale_quality(D, P, e, r)
    assert after < 2.0 and after == jax_scaling.kkt_scale_quality(D, P, je, jr)


def test_ruiz_p_only():
    P = np.diag([1e-4, 1.0, 1e4])
    e, r = scaling.ruiz_equilibrate(None, P)
    assert r.size == 0
    assert scaling.kkt_scale_quality(np.zeros((0, 3)), P, e) < 1.5
    np.testing.assert_array_equal(e, jax_scaling.ruiz_equilibrate(None, P)[0])
    with pytest.raises(ValueError, match="at least one"):
        scaling.ruiz_equilibrate(None, None)


def test_lp_preconditioned_matches_reparameterized_oracle():
    rng = np.random.default_rng(0)
    b, D, s = _pc_lp_instance(rng)
    m, n = D.shape
    ref = linearprogram(b, D, s, ADMMConfig(**TIGHT), device="cpu")
    assert ref.steps < TIGHT["maxiters"]
    xstar = ref.xopt.numpy()
    G, F = _bad_scales(rng, m, n)
    Dbad, sbad, bbad = G[:, None] * D * F[None, :], G * s, F * b
    ystar = xstar / F  # y = F^{-1} x keeps the objective: (F b)^T y = b^T x
    cfg = dict(abstol=1e-8, reltol=1e-8, maxiters=40000, unroll=16)
    res_pre = linearprogram(bbad, Dbad, sbad, ADMMConfig(**cfg), precondition=True,
                            device="cpu")
    assert_same_run(res_pre, jax_lp(bbad, Dbad, sbad, JaxConfig(**cfg), precondition=True))
    # The plain solve, cut one step past the preconditioned one's count: a
    # run that gets that far would also have run longer uncut, and one that
    # stops before runs exactly as it would uncut.
    res_plain = linearprogram(bbad, Dbad, sbad, ADMMConfig(**dict(
        cfg, maxiters=res_pre.steps + 1)), device="cpu")
    fstar = float(b @ xstar)
    f_pre = float(bbad @ res_pre.xopt.numpy())
    assert abs(f_pre - fstar) <= 1e-5 * (1.0 + abs(fstar))
    np.testing.assert_allclose(res_pre.xopt.numpy(), ystar, rtol=1e-3,
                               atol=1e-5 * np.max(np.abs(ystar)))
    f_plain = float(bbad @ res_plain.xopt.numpy())
    plain_bad = abs(f_plain - fstar) > 1e2 * abs(f_pre - fstar)
    assert res_pre.steps < res_plain.steps or plain_bad
    assert set(res_pre.extra) == {"ruiz_col", "ruiz_row"}


def test_qp_standard_preconditioned():
    rng = np.random.default_rng(1)
    m, n = 30, 80
    A0 = rng.standard_normal((n, n))
    P = A0 @ A0.T + 0.5 * np.eye(n)
    q = rng.standard_normal(n)
    D = rng.standard_normal((m, n))
    s = D @ np.abs(rng.standard_normal(n))
    ref = quadraticprogram(P, q, 0.0, D, s, ADMMConfig(**TIGHT), device="cpu")
    assert ref.steps < TIGHT["maxiters"]
    xstar = ref.xopt.numpy()
    fstar = 0.5 * xstar @ P @ xstar + q @ xstar
    G, F = _bad_scales(rng, m, n)
    Pb, qb = F[:, None] * P * F[None, :], F * q
    Db, sb = G[:, None] * D * F[None, :], G * s
    cfg = dict(abstol=1e-8, reltol=1e-8, maxiters=40000, unroll=16)
    res = quadraticprogram(Pb, qb, 0.0, Db, sb, ADMMConfig(**cfg), precondition=True,
                           device="cpu")
    assert_same_run(res, jax_qp(Pb, qb, 0.0, Db, sb, JaxConfig(**cfg), precondition=True))
    y = res.xopt.numpy()
    assert abs(0.5 * y @ Pb @ y + qb @ y - fstar) <= 1e-5 * (1.0 + abs(fstar))
    np.testing.assert_allclose(y, xstar / F, rtol=1e-3, atol=1e-5 * np.max(np.abs(xstar / F)))


def test_qp_bounded_preconditioned():
    rng = np.random.default_rng(2)
    n = 60
    A0 = rng.standard_normal((n, n))
    P = A0 @ A0.T + np.eye(n)
    q = rng.standard_normal(n)
    lb, ub = -0.2 * np.ones(n), 0.2 * np.ones(n)
    xstar = quadraticprogram(P, q, 0.0, lb, ub, ADMMConfig(**TIGHT), device="cpu").xopt.numpy()
    F = 10.0 ** rng.uniform(-2, 2, n)
    Pb, qb = F[:, None] * P * F[None, :], F * q
    cfg = dict(abstol=1e-8, reltol=1e-8, maxiters=40000, unroll=16)
    res = quadraticprogram(Pb, qb, 0.0, lb / F, ub / F, ADMMConfig(**cfg), precondition=True,
                           device="cpu")
    assert_same_run(res, jax_qp(Pb, qb, 0.0, lb / F, ub / F, JaxConfig(**cfg),
                                precondition=True))
    np.testing.assert_allclose(F * res.xopt.numpy(), xstar, rtol=1e-4, atol=1e-6)
    assert res.extra["ruiz_row"] is None


def test_precondition_composes_with_anderson():
    rng = np.random.default_rng(3)
    b, D, s = _pc_lp_instance(rng, 30, 90)
    G, F = _bad_scales(rng, 30, 90)
    cfg = dict(abstol=1e-8, reltol=1e-8, maxiters=40000, anderson=10, unroll=16)
    res = linearprogram(F * b, G[:, None] * D * F[None, :], G * s, ADMMConfig(**cfg),
                        precondition=True, device="cpu")
    f0 = float(b @ linearprogram(b, D, s, ADMMConfig(**TIGHT), device="cpu").xopt.numpy())
    assert abs(float((F * b) @ res.xopt.numpy()) - f0) <= 1e-5 * (1.0 + abs(f0))
    # AA's window solve amplifies the two LAPACKs' rounding (ROADMAP.md
    # queue 3), and over ~1,000 steps on this badly scaled instance the two
    # packages' runs part (1251 and 1759 steps): both land on the optimum.
    jres = jax_lp(F * b, G[:, None] * D * F[None, :], G * s, JaxConfig(**cfg),
                  precondition=True)
    assert abs(float((F * b) @ np.asarray(jres.xopt)) - f0) <= 1e-5 * (1.0 + abs(f0))


def test_dual_unscaling_direction():
    # The scaled dual transforms as u~ = e u, so the returned uopt is u~/e;
    # on a mildly scaled instance the plain and preconditioned duals agree.
    rng = np.random.default_rng(4)
    b, D, s = _pc_lp_instance(rng, 30, 90)
    G, F = _bad_scales(rng, 30, 90, 1.0)
    Db, sb, bb = G[:, None] * D * F, G * s, F * b
    cfg = ADMMConfig(abstol=1e-9, reltol=1e-9, maxiters=60000, unroll=16)
    rp = linearprogram(bb, Db, sb, cfg, device="cpu")
    rpre = linearprogram(bb, Db, sb, cfg, precondition=True, device="cpu")
    up, upre = rp.uopt.numpy(), rpre.uopt.numpy()
    np.testing.assert_allclose(upre, up, rtol=5e-2, atol=1e-2 * np.max(np.abs(up)))
    # Warm-starting from its own solution (tensors this time) round-trips
    # the x0/z0/u0 scaling and reconverges at once.
    rws = linearprogram(bb, Db, sb, cfg, precondition=True, x0=rpre.xopt, z0=rpre.zopt,
                        u0=rpre.uopt, device="cpu")
    assert rws.steps <= max(5, 0.02 * rpre.steps)
    jws = jax_lp(bb, Db, sb, JaxConfig(abstol=1e-9, reltol=1e-9, maxiters=60000),
                 precondition=True, x0=rpre.xopt.numpy(), z0=rpre.zopt.numpy(),
                 u0=rpre.uopt.numpy())
    assert rws.steps == jws.steps


def test_bad_scaling_warning():
    rng = np.random.default_rng(5)
    b, D, s = _pc_lp_instance(rng, 20, 60)
    G, F = _bad_scales(rng, 20, 60, 3.0)
    cfg = ADMMConfig(maxiters=50)
    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        linearprogram(F * b, G[:, None] * D * F, G * s, cfg, device="cpu")
        quadraticprogram(F[:, None] * np.eye(60) * F, F * b, 0.0, G[:, None] * D * F, G * s,
                         cfg, device="cpu")
    hits = [x for x in w if "badly scaled" in str(x.message)]
    assert len(hits) == 2 and all(x.filename == __file__ for x in hits)
    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        linearprogram(b, D, s, cfg, device="cpu")
        linearprogram(F * b, G[:, None] * D * F, G * s, cfg, precondition=True, device="cpu")
        # Tensors skip the check (it would copy them to the host).
        linearprogram(*(torch.from_numpy(a) for a in (F * b, G[:, None] * D * F, G * s)), cfg)
    assert not any("badly scaled" in str(x.message) for x in w)


def test_well_scaled_noop_quality():
    rng = np.random.default_rng(6)
    b, D, s = _pc_lp_instance(rng, 20, 60)
    cfg = ADMMConfig(abstol=1e-8, reltol=1e-8, maxiters=60000, unroll=16)
    f0 = float(b @ linearprogram(b, D, s, cfg, device="cpu").xopt.numpy())
    f1 = float(b @ linearprogram(b, D, s, cfg, precondition=True, device="cpu").xopt.numpy())
    assert abs(f1 - f0) <= 1e-6 * (1.0 + abs(f0))


# ---- tests/test_illconditioned.py through the port ------------------------

def test_lasso_with_duplicated_columns():
    rng = np.random.default_rng(0)
    base = rng.standard_normal((80, 10))
    D = np.concatenate([base, base], axis=1)  # rank 10, 20 columns
    x_true = np.zeros(20)
    x_true[:3] = [1.0, -2.0, 0.5]
    s = D @ x_true + 0.01 * rng.standard_normal(80)
    lam = 0.1 * np.max(np.abs(D.T @ s))
    res = lasso(D, s, lam, ADMMConfig(maxiters=3000), device="cpu")
    assert not res.diverged
    x = res.xopt.numpy()
    obj = 0.5 * np.sum((D @ x - s) ** 2) + lam * np.sum(np.abs(x))
    obj_true = 0.5 * np.sum((D @ x_true - s) ** 2) + lam * np.sum(np.abs(x_true))
    assert obj <= obj_true * (1 + 1e-6)
    assert_same_run(res, jax_lasso(D, s, lam, JaxConfig(maxiters=3000)))


def test_symshift_solver_on_near_singular_gram():
    rng = np.random.default_rng(1)
    Q, _ = np.linalg.qr(rng.standard_normal((50, 50)))
    G = (Q * np.geomspace(1e-12, 1.0, 50)) @ Q.T
    b = rng.standard_normal(50)
    x = solve.SymShiftSolver.from_matrix(torch.from_numpy(G)).solve(torch.from_numpy(b),
                                                                     0.5).numpy()
    assert np.linalg.norm((G + 0.5 * np.eye(50)) @ x - b) / np.linalg.norm(b) < 1e-10
    jx = np.asarray(jax_solve.SymShiftSolver.from_matrix(jnp.asarray(G)).solve(b, 0.5))
    np.testing.assert_allclose(x, jx, rtol=1e-10, atol=1e-12)


@pytest.mark.parametrize("scale", [1e-6, 1e6])
def test_lasso_extreme_data_scaling(scale):
    rng = np.random.default_rng(2)
    D = rng.standard_normal((60, 30)) * scale
    s = rng.standard_normal(60) * scale
    lam = 0.1 * np.max(np.abs(D.T @ s))
    res = lasso(D, s, lam, ADMMConfig(maxiters=4000, rho=scale**2), device="cpu")
    assert not res.diverged and np.all(np.isfinite(res.xopt.numpy()))
    assert res.steps < 4000
    assert_same_run(res, jax_lasso(D, s, lam, JaxConfig(maxiters=4000, rho=scale**2)))
