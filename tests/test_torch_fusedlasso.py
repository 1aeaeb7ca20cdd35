"""The fused lasso of the port (admm_tpu_torch/models/fusedlasso.py) and
its operator ``linop.StackIDiffOp`` against admm_tpu's on the same numpy
inputs in f64: on admm_tpu's setup carried across
(``convert.fusedlasso_data``) to isolate the iteration, with each package
doing its own eig-fold, and the two closed-form oracles of
tests/test_extra_models.py::TestFusedLasso (lam2 = 0 is the soft
threshold, lam1 = 0 is the TV denoiser) run through the port."""

import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from admm_tpu import ADMMConfig as JaxConfig
from admm_tpu import fusedlasso as jax_fusedlasso
from admm_tpu.engine import Hooks as JaxHooks
from admm_tpu.engine import admm as jax_admm
from admm_tpu.linop import StackIDiffOp as JaxStackIDiffOp
from admm_tpu_torch import ADMMConfig, Hooks, admm, fusedlasso, totalvariation
from admm_tpu_torch.convert import fusedlasso_data, numpy_state
from admm_tpu_torch.linop import DiffOp, StackIDiffOp
from admm_tpu_torch.ops.prox import soft_threshold

from _parity import assert_same_run

torch.set_num_threads(1)
jax_fl_mod = importlib.import_module("admm_tpu.models.fusedlasso")
fl_mod = importlib.import_module("admm_tpu_torch.models.fusedlasso")

# test_extra_models.py's _CFG: tolerances far below the f64 floor.
_CFG = dict(maxiters=20000, abstol=1e-12, reltol=1e-12)
VARIANTS = {"plain": {}, "relax": {"relax": 1.5}, "rbadaptive": {"rbadaptive": True},
            "unroll": {"unroll": 3}}


def _signal(seed, n=200):
    # TestFusedLasso._signal.
    rng = np.random.default_rng(seed)
    return np.repeat(rng.standard_normal(n // 20), 20) + 0.3 * rng.standard_normal(n)


@pytest.mark.parametrize("n", [1, 2, 17])
def test_stackidiffop_is_the_dense_stack_and_matches_jax(n):
    rng = np.random.default_rng(n)
    v, w = rng.standard_normal(n), rng.standard_normal(2 * n)
    op, jop = StackIDiffOp(n), JaxStackIDiffOp(n)
    dense = np.vstack([np.eye(n), DiffOp(n).dense().numpy()])  # [I; D]
    np.testing.assert_allclose(op.mv(torch.from_numpy(v)).numpy(), dense @ v, atol=1e-14)
    np.testing.assert_allclose(op.rmv(torch.from_numpy(w)).numpy(), dense.T @ w, atol=1e-14)
    np.testing.assert_array_equal(op.mv(torch.from_numpy(v)).numpy(),
                                  np.asarray(jop.mv(jnp.asarray(v))))
    np.testing.assert_array_equal(op.rmv(torch.from_numpy(w)).numpy(),
                                  np.asarray(jop.rmv(jnp.asarray(w))))
    assert op.out_shape((n,)) == jop.out_shape((n,)) == (2 * n,)
    assert repr(op) == f"StackIDiffOp({n})"


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_fusedlasso_iteration_on_carried_state(variant):
    sig = _signal(1, 120)
    n = sig.shape[0]
    cfg = dict(maxiters=3000, objevals=True, **VARIANTS[variant])
    jcfg = JaxConfig(**cfg)
    pf, pg, obj, jdata, A = jax_fl_mod.make_prox_ops(sig, 0.2, 0.5, jcfg)
    jres = jax_admm(pf, pg, jcfg, A=A, B=-1.0, c=0.0, m=2 * n, nA=n, nB=2 * n,
                    hooks=JaxHooks(obj=obj), dtype=jnp.float64, data=jdata)
    state = numpy_state(jdata)
    dynamic = variant == "rbadaptive"
    assert sorted(state) == (["V", "s", "t", "w"] if dynamic else ["Minv", "s", "t"])
    data, _ = fusedlasso_data(state)
    assert isinstance(data["A"], StackIDiffOp) and data["A"].n == n
    prox_f = fl_mod._prox_f_adaptive if dynamic else fl_mod._prox_f
    prox_g = fl_mod._prox_g if variant != "relax" else fl_mod._prox_g_relaxed
    res = admm(prox_f, prox_g, ADMMConfig(**cfg), A=data["A"], B=-1.0, c=0.0, m=2 * n,
               nA=n, nB=2 * n, hooks=Hooks(obj=fl_mod._obj), dtype=torch.float64, data=data)
    assert res.steps < 3000
    assert_same_run(res, jres)


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_fusedlasso_matches_jax_f64(variant):
    # Each package runs its own eigh of D^T D in f64: the eigenvectors'
    # signs may differ, but Minv = V diag V^T does not see them; the runs
    # agree to ~1e-14 relative, held to the parity bar.
    sig = _signal(2)
    cfg = dict(maxiters=3000, objevals=True, **VARIANTS[variant])
    jres = jax_fusedlasso(sig, 0.15, 0.6, JaxConfig(**cfg))
    res = fusedlasso(sig, 0.15, 0.6, ADMMConfig(**cfg), device="cpu")
    assert res.xopt.shape == (200,) and res.zopt.shape == (400,)
    assert_same_run(res, jres)


def test_lam2_zero_is_soft_threshold_closed_form():
    s = _signal(0)
    r = fusedlasso(s, 0.4, 0.0, ADMMConfig(**_CFG), device="cpu")
    np.testing.assert_allclose(r.xopt.numpy(), soft_threshold(torch.from_numpy(s), 0.4).numpy(),
                               atol=1e-8)


def test_lam1_zero_matches_tv():
    s = _signal(0)
    r = fusedlasso(s, 0.0, 0.6, ADMMConfig(**_CFG), device="cpu")
    tv = totalvariation(s, 0.6, ADMMConfig(**_CFG), solver="dense", device="cpu")
    np.testing.assert_allclose(r.xopt.numpy(), tv.xopt.numpy(), atol=1e-7)


def test_general_case_structure_and_relax():
    s = _signal(0)
    r = fusedlasso(s, 0.15, 0.6, ADMMConfig(**_CFG), device="cpu")
    x = r.xopt.numpy()
    n = len(s)
    # Exact zeros (l1) and far fewer distinct levels than samples (fused).
    assert np.sum(np.abs(x) < 1e-6) > n // 10
    assert len(np.unique(np.round(x, 5))) < n // 4
    r2 = fusedlasso(s, 0.15, 0.6, ADMMConfig(**_CFG), relax=1.5, device="cpu")
    np.testing.assert_allclose(r2.xopt.numpy(), x, atol=1e-8)


def test_objective_subgradient_optimality():
    # |rho*u| <= t elementwise (the stacked scaled dual).
    s = _signal(0, n=120)
    lam1, lam2, rho = 0.2, 0.5, 1.0
    r = fusedlasso(s, lam1, lam2, ADMMConfig(**_CFG), rho=rho, device="cpu")
    t = np.r_[np.full(120, lam1), np.full(120, lam2)]
    assert np.all(rho * np.abs(r.uopt.numpy()) <= t + 1e-6)


def test_fusedlasso_f32_on_tensors():
    sig = torch.from_numpy(_signal(3, 400).astype(np.float32))
    res = fusedlasso(sig, 0.1, 0.5, ADMMConfig(maxiters=3000))
    ref = fusedlasso(sig.double(), 0.1, 0.5, ADMMConfig(maxiters=3000))
    assert res.xopt.dtype == torch.float32 and res.xopt.device == sig.device
    assert abs(res.steps - ref.steps) <= 1
    np.testing.assert_allclose(res.xopt.numpy(), ref.xopt.numpy(), rtol=0,
                               atol=1e-4 * float(torch.max(torch.abs(ref.xopt))))

