"""Regularization paths of the port (admm_tpu_torch/models/paths.py), the port
of tests/test_paths.py: every lane held against admm_tpu's path on the same
numpy inputs in f64 (``_parity.assert_same_lanes``: equal steps, iterates to
rtol 1e-9, histories to 1e-8 of their first value) and against the port's
serial solve (``_parity.assert_lane_is_solo``: equal steps, rtol 1e-9)."""

import numpy as np
import pytest
import torch

import admm_tpu as J
import admm_tpu_torch as T
from admm_tpu.models import paths as jax_paths
from admm_tpu_torch import ADMMConfig

from _parity import assert_lane_is_solo, assert_same_lanes

torch.set_num_threads(1)


def test_lasso_path_matches_individual_solves():
    rng = np.random.default_rng(0)
    D = rng.standard_normal((128, 64))
    D = D / np.sqrt(np.sum(D**2, axis=0, keepdims=True))
    s = D @ (rng.standard_normal(64) * (rng.random(64) < 0.5)) + 0.03 * rng.standard_normal(128)
    lams = np.max(np.abs(D.T @ s)) * np.array([0.5, 0.1, 0.02])
    path = T.lasso_path(D, s, lams, ADMMConfig(maxiters=5000), device="cpu")
    jpath = jax_paths.lasso_path(D, s, lams, J.ADMMConfig(maxiters=5000))
    assert path.xopt.shape == (3, 64)
    assert_same_lanes(path, jpath)
    for i, lam in enumerate(lams):
        assert_lane_is_solo(path, i, T.lasso(D, s, float(lam), ADMMConfig(maxiters=5000),
                                             device="cpu"))
    nnz = [(path.zopt[i].abs() > 1e-8).sum() for i in range(3)]
    assert nnz[0] <= nnz[-1]


def test_svm_c_path_matches_serial_per_C():
    # tests/test_paths.py::test_svm_c_path_runs, with each lane held against
    # the port's serial linearsvm from the same random start.  admm_tpu's
    # path draws its start from jax.random and takes no x0, so the two
    # packages' paths part from the first step and are not compared.
    rng = np.random.default_rng(1)
    mpos = 64
    bp = np.linspace(0, 2, mpos)
    pos = np.stack([bp + rng.random(mpos) - 0.25 * rng.random(mpos),
                    bp - rng.random(mpos) + 0.25 * rng.random(mpos)], 1)
    neg = np.stack([bp - rng.random(mpos) + 0.25 * rng.random(mpos),
                    bp + rng.random(mpos) - 0.25 * rng.random(mpos)], 1)
    D = np.concatenate([pos, neg])
    ell = np.concatenate([np.ones(mpos), -np.ones(mpos)])
    Cs = np.array([0.1, 1.0, 10.0])
    path = T.linearsvm_c_path(D, ell, Cs, ADMMConfig(maxiters=500), device="cpu")
    assert path.xopt.shape == (3, 2) and torch.isfinite(path.xopt).all()
    for i, C in enumerate(Cs):
        solo = T.linearsvm(D, ell, float(C), ADMMConfig(maxiters=500), device="cpu")
        assert_lane_is_solo(path, i, solo)


def test_covsel_path_matches_individual_solves():
    rng = np.random.default_rng(2)
    n = 16
    Sinv = np.eye(n)
    Sinv[1, 5] = Sinv[5, 1] = 0.8
    D = rng.multivariate_normal(np.zeros(n), np.linalg.inv(Sinv), size=200)
    lams = np.array([2.0, 0.5, 0.1])
    path = T.covsel_path(D, lams, ADMMConfig(maxiters=500), device="cpu")
    jpath = jax_paths.covsel_path(D, lams, J.ADMMConfig(maxiters=500))
    assert path.xopt.shape == (3, n, n)
    assert_same_lanes(path, jpath)
    for i, lam in enumerate(lams):
        solo = T.covarianceselection(D, float(lam), ADMMConfig(maxiters=500), prox_method="ns",
                                     device="cpu")
        assert_lane_is_solo(path, i, solo)
    Z = path.zopt.numpy()
    off = [(np.abs(Z[i] - np.diag(np.diag(Z[i]))) > 1e-8).sum() for i in range(3)]
    assert off[0] <= off[-1]


@pytest.mark.parametrize("solver", ["dense", "cr"])
def test_tv_path_matches_individual_solves(solver):
    rng = np.random.default_rng(4)
    n = 128
    s = np.repeat(rng.standard_normal(8), n // 8) + 0.3 * rng.standard_normal(n)
    lams = np.array([2.0, 0.5, 0.05])
    cfg = ADMMConfig(maxiters=2000)
    path = T.tv_path(s, lams, cfg, solver=solver, device="cpu")
    jpath = jax_paths.tv_path(s, lams, J.ADMMConfig(maxiters=2000), solver=solver)
    assert path.xopt.shape == (3, n)
    assert_same_lanes(path, jpath)
    for i, lam in enumerate(lams):
        assert_lane_is_solo(path, i, T.totalvariation(s, float(lam), cfg, solver=solver,
                                                      device="cpu"))
    tv = [np.abs(np.diff(path.xopt[i].numpy())).sum() for i in range(3)]
    assert tv[0] <= tv[1] <= tv[2]


def test_lasso_path_unroll_exact():
    # Lanes with unroll = 4 equal unroll = 1 bit for bit: every sub-step
    # freezes the lanes that are done.
    rng = np.random.default_rng(0)
    D = rng.standard_normal((64, 32))
    s = rng.standard_normal(64)
    lams = np.geomspace(0.01, 1.0, 8)
    base = T.lasso_path(D, s, lams, ADMMConfig(maxiters=501), device="cpu")
    un = T.lasso_path(D, s, lams, ADMMConfig(maxiters=501, unroll=4), device="cpu")
    assert torch.equal(un.steps, base.steps) and torch.equal(un.xopt, base.xopt)
    assert len(set(base.steps.tolist())) > 1
    for name, trace in base.hist.items():
        assert torch.equal(un.hist[name].isnan(), trace.isnan())
        assert torch.equal(torch.nan_to_num(un.hist[name]), torch.nan_to_num(trace))
