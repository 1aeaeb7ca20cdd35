"""LAD, Huber fitting and quantile regression of the port
(admm_tpu_torch/models/{lad,huberfit,quantile}.py, one normal-equations
x-update, ``_common.normal_equations_data``) against admm_tpu's on the
same numpy inputs in f64: on admm_tpu's setup carried across
(``convert.lasso_data``, whose state D leads) to isolate the iteration, with each package
doing its own solve for (D^T D)^{-1} D^T, the proxes on their own, and
the oracles of tests/test_extra_models.py::TestQuantileRegression (scipy's
``linprog`` and tau = 0.5 against LAD) run through the port."""

import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import admm_tpu
from admm_tpu import ADMMConfig as JaxConfig
from admm_tpu.engine import Hooks as JaxHooks
from admm_tpu.engine import admm as jax_admm
from admm_tpu.ops import prox as jax_prox
from admm_tpu_torch import ADMMConfig, Hooks, admm, huberfit, lad, quantile
from admm_tpu_torch.convert import lasso_data, numpy_state
from admm_tpu_torch.models._common import normal_equations_data
from admm_tpu_torch.models.huberfit import huber_loss
from admm_tpu_torch.ops import prox

from _parity import assert_same_run

torch.set_num_threads(1)
FAMILIES = ("lad", "huberfit", "quantile")
_PORT = {"lad": lad, "huberfit": huberfit, "quantile": quantile}
_MODS = {f: (importlib.import_module(f"admm_tpu.models.{f}"),
             importlib.import_module(f"admm_tpu_torch.models.{f}")) for f in FAMILIES}
VARIANTS = {"plain": {}, "relax": {"relax": 1.5}, "rbadaptive": {"rbadaptive": True},
            "unroll": {"unroll": 3}}


def _instance(seed, m=80, n=12, noise=0.05):
    # test_extra_models.py's _instance.
    rng = np.random.default_rng(seed)
    D = rng.standard_normal((m, n))
    xtrue = rng.standard_normal(n) * (rng.random(n) < 0.4)
    return D, D @ xtrue + noise * rng.standard_normal(m)


def _family_instance(family, seed):
    # Huber fitting needs residuals beyond its quadratic zone |r| <= 1:
    # with 0.05 noise it is least squares, solved to rounding noise in its
    # first steps, and its histories would compare noise.
    return _instance(seed, noise=2.0 if family == "huberfit" else 0.05)


def _args(family):
    """Positional arguments after (D, s)."""
    return (0.8,) if family == "quantile" else ()


@pytest.mark.parametrize("variant", sorted(VARIANTS))
@pytest.mark.parametrize("family", FAMILIES)
def test_iteration_on_carried_state(family, variant):
    D, s = _family_instance(family, 1)
    m, n = D.shape
    jmod, mod = _MODS[family]
    cfg = dict(maxiters=3000, objevals=True, **VARIANTS[variant])
    jcfg = JaxConfig(**cfg)
    pf, pg, obj, jdata = jmod.make_prox_ops(D, s, *_args(family), config=jcfg)
    jres = jax_admm(pf, pg, jcfg, A=jdata["D"], B=-1.0, c=jdata["s"], m=m, nA=n, nB=m,
                    hooks=JaxHooks(obj=obj), dtype=jnp.float64, data=jdata)
    state = numpy_state(jdata)
    assert sorted(state) == sorted(["D", "Dplus", "s"] + (["tau"] if family == "quantile" else []))
    data, _ = lasso_data(state)
    prox_g = mod._prox_g if variant != "relax" else mod._prox_g_relaxed
    res = admm(mod._prox_f, prox_g, ADMMConfig(**cfg), A=data["D"], B=-1.0, c=data["s"], m=m,
               nA=n, nB=m, hooks=Hooks(obj=mod._obj), dtype=torch.float64, data=data)
    assert res.steps < 3000
    assert_same_run(res, jres)


@pytest.mark.parametrize("variant", sorted(VARIANTS))
@pytest.mark.parametrize("family", FAMILIES)
def test_family_matches_jax_f64(family, variant):
    # Each package runs its own solve for Dplus in f64; the runs agree to
    # ~1e-14 relative, held to the parity bar.
    D, s = _family_instance(family, 2)
    cfg = dict(maxiters=3000, objevals=True, **VARIANTS[variant])
    jres = getattr(admm_tpu, family)(D, s, *_args(family), JaxConfig(**cfg))
    res = _PORT[family](D, s, *_args(family), ADMMConfig(**cfg), device="cpu")
    assert res.xopt.dtype == torch.float64 and res.xopt.device.type == "cpu"
    assert_same_run(res, jres)
    np.testing.assert_allclose(res.objopt, jres.objopt, rtol=1e-10)


def test_normal_equations_data_matches_jax_and_refuses_fat_d():
    D, s = _instance(3)
    data = normal_equations_data(torch.from_numpy(D), torch.from_numpy(s))
    jdata = admm_tpu.models._common.normal_equations_data(D, s)
    np.testing.assert_allclose(data["Dplus"].numpy(), np.asarray(jdata["Dplus"]), rtol=0,
                               atol=1e-13)
    np.testing.assert_allclose(data["Dplus"].numpy() @ D, np.eye(12), atol=1e-12)
    with pytest.raises(ValueError, match="at least as many rows") as port:
        normal_equations_data(torch.from_numpy(D.T.copy()), torch.zeros(12, dtype=torch.float64))
    with pytest.raises(ValueError) as ref:
        admm_tpu.models._common.normal_equations_data(D.T, np.zeros(12))
    assert str(port.value) == str(ref.value)


@pytest.mark.parametrize("t_pos,t_neg", [(0.3, 0.3), (0.2, 0.7), (0.0, 1.5)])
def test_asymmetric_soft_threshold_matches_jax(t_pos, t_neg):
    v = np.random.default_rng(4).standard_normal(200) * 2
    out = prox.asymmetric_soft_threshold(torch.from_numpy(v), t_pos, t_neg).numpy()
    np.testing.assert_array_equal(out, np.asarray(jax_prox.asymmetric_soft_threshold(v, t_pos,
                                                                                     t_neg)))
    np.testing.assert_array_equal(out, np.where(v > t_pos, v - t_pos,
                                                np.where(v < -t_neg, v + t_neg, 0.0)))
    # The thresholds as 0-d tensors give the same numbers.
    t = torch.tensor([t_pos, t_neg], dtype=torch.float64)
    np.testing.assert_array_equal(
        prox.asymmetric_soft_threshold(torch.from_numpy(v), t[0], t[1]).numpy(), out)


@pytest.mark.parametrize("rho", [0.5, 1.7])
def test_huber_prox_and_loss_match_jax(rho):
    rng = np.random.default_rng(5)
    Ax, u, s = (rng.standard_normal(100) * 2 for _ in range(3))
    out = prox.huber_prox(*(torch.from_numpy(a) for a in (Ax, u, s)), rho)
    np.testing.assert_allclose(out.numpy(), np.asarray(jax_prox.huber_prox(Ax, u, s, rho)),
                               rtol=1e-15, atol=1e-15)
    same = prox.huber_prox(*(torch.from_numpy(a) for a in (Ax, u, s)),
                           torch.tensor(rho, dtype=torch.float64))
    assert torch.equal(same, out)
    a = rng.standard_normal(100) * 2
    jmod = _MODS["huberfit"][0]
    np.testing.assert_allclose(huber_loss(torch.from_numpy(a)).numpy(),
                               np.asarray(jmod.huber_loss(a)), rtol=1e-15)


def _lp_oracle(D, s, tau):
    # TestQuantileRegression._lp_oracle: min tau 1'p + (1-tau) 1'q
    # s.t. Dx - s = p - q, p, q >= 0.
    from scipy.optimize import linprog

    m, n = D.shape
    out = linprog(np.r_[np.zeros(n), tau * np.ones(m), (1 - tau) * np.ones(m)],
                  A_eq=np.c_[D, -np.eye(m), np.eye(m)], b_eq=s,
                  bounds=[(None, None)] * n + [(0, None)] * (2 * m), method="highs")
    assert out.status == 0
    return out.fun


_ORACLE_CFG = dict(maxiters=20000, abstol=1e-12, reltol=1e-12)


@pytest.mark.parametrize("tau", [0.2, 0.5, 0.8])
def test_quantile_objective_matches_lp_oracle(tau):
    rng = np.random.default_rng(0)
    D, s = rng.standard_normal((80, 12)), rng.standard_normal(80)
    res = quantile(D, s, tau, ADMMConfig(**_ORACLE_CFG), objevals=True, device="cpu")
    r = D @ res.xopt.numpy() - s
    f_admm = float(np.sum(np.maximum(tau * r, (tau - 1) * r)))
    np.testing.assert_allclose(f_admm, _lp_oracle(D, s, tau), rtol=1e-5, atol=1e-9)


def test_quantile_tau_half_matches_lad():
    D, s = _instance(6, m=100, n=10)
    q = quantile(D, s, 0.5, ADMMConfig(**_ORACLE_CFG), device="cpu")
    ref = lad(D, s, ADMMConfig(**_ORACLE_CFG), device="cpu")
    # Same minimizer (pinball_0.5 = 0.5 |.|); the iterates differ.
    np.testing.assert_allclose(q.xopt.numpy(), ref.xopt.numpy(), rtol=0, atol=2e-6)


@pytest.mark.parametrize("family", FAMILIES)
def test_f32_on_tensors_within_the_f32_bar(family):
    # admm_tpu/benchmarks/matrix.py's f32 bars: LAD and quantile 1e-2,
    # Huber 1e-3, on the objective against the f64 solve.
    D, s = _instance(7, m=200, n=20)
    D32, s32 = torch.from_numpy(D.astype(np.float32)), torch.from_numpy(s.astype(np.float32))
    cfg = ADMMConfig(maxiters=5000, abstol=1e-7, reltol=1e-6, stallwindow=100, objevals=True)
    res = _PORT[family](D32, s32, *_args(family), cfg)
    ref = _PORT[family](D32.double(), s32.double(), *_args(family), cfg)
    assert res.xopt.dtype == torch.float32 and res.xopt.device == D32.device
    bar = 1e-3 if family == "huberfit" else 1e-2
    assert abs(res.objopt - ref.objopt) <= bar * abs(ref.objopt)


def test_refusals():
    D, s = _instance(8)
    for tau in (0.0, 1.0, -0.2):
        with pytest.raises(ValueError, match=r"tau must be in \(0, 1\)"):
            quantile(D, s, tau, device="cpu")
    with pytest.raises(ValueError, match="at least as many rows"):
        lad(D.T, s[:12], device="cpu")
    for fn in (lad, huberfit):
        with pytest.raises(NotImplementedError, match="slice 11"):
            fn()
