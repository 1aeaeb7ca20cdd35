"""Instance batches of the port (admm_tpu_torch/models/batch.py), the ports of
tests/test_batch.py and of the ``*_batch`` cases of tests/test_extra_models.py:
every lane held against admm_tpu's batched result on the same numpy inputs
in f64 (``_parity.assert_same_lanes``: equal steps, iterates to rtol 1e-9,
histories to 1e-8 of their first value) and against the port's serial
solve of the same instance (``_parity.assert_lane_is_solo``: equal steps,
rtol 1e-9), unless a test states another bar; ``mesh=`` on a stacked mesh
equals the unsharded run bit for bit."""

import warnings

import numpy as np
import pytest
import torch

import admm_tpu as J
import admm_tpu_torch as T
from admm_tpu_torch import ADMMConfig

from _parity import assert_lane_is_solo, assert_same_lanes

torch.set_num_threads(1)


def _cfg(**kw):
    return ADMMConfig(**kw), J.ADMMConfig(**kw)


def _lasso_instances(B=3, m=48, n=96, seed=0):
    rng = np.random.default_rng(seed)
    D = rng.standard_normal((m, n))
    D = D / np.sqrt(np.sum(D**2, axis=0, keepdims=True))
    X = rng.standard_normal((B, n)) * (rng.random((B, n)) < 0.2)
    S = X @ D.T + 0.02 * rng.standard_normal((B, m))
    return D, S


def _rhs_instances(B=3, m=96, n=24, seed=5):
    rng = np.random.default_rng(seed)
    D = rng.standard_normal((m, n))
    X = rng.standard_normal((B, n))
    S = X @ D.T + 0.05 * rng.standard_normal((B, m))
    S[:, ::10] += 3.0
    return D, S


def _both(name, *args, **kw):
    """The port's (on the CPU, with no fallback of vmap to a lane loop) and
    admm_tpu's batched solves of the same call; ``cfg`` keyword holds the
    (port, jax) configs."""
    cfg, jcfg = kw.pop("cfg")
    with warnings.catch_warnings(record=True) as seen:
        warnings.simplefilter("always")
        out = getattr(T, name)(*args, cfg, device="cpu", **kw)
    assert not [w for w in seen if "batching rule" in str(w.message)]
    return out, getattr(J, name)(*args, jcfg, **kw)


def test_lasso_batch_matches_serial_per_instance():
    D, S = _lasso_instances()
    lam = 0.1 * np.max(np.abs(S @ D))
    cfg = _cfg(maxiters=3000)
    out, jout = _both("lasso_batch", D, S, lam, cfg=cfg)
    assert out.xopt.shape == (3, 96)
    assert_same_lanes(out, jout)
    for i in range(3):
        solo = T.lasso(D, S[i], float(lam), cfg[0], device="cpu")
        assert_lane_is_solo(out, i, solo)
        np.testing.assert_allclose(float(out.objopt[i]), solo.objopt, rtol=1e-10)


def test_lasso_batch_per_instance_lambdas():
    D, S = _lasso_instances(B=2)
    lam0 = 0.1 * np.max(np.abs(S @ D))
    lams = np.array([lam0, 0.3 * lam0])
    cfg = _cfg(maxiters=3000)
    out, jout = _both("lasso_batch", D, S, lams, cfg=cfg)
    assert_same_lanes(out, jout)
    for i, lam in enumerate(lams):
        assert_lane_is_solo(out, i, T.lasso(D, S[i], float(lam), cfg[0], device="cpu"))


@pytest.mark.parametrize("m,n", [(32, 80), (80, 32)])
def test_lasso_batch_skinny_and_fat_branches(m, n):
    rng = np.random.default_rng(m)
    D = rng.standard_normal((m, n))
    D = D / np.sqrt(np.sum(D**2, axis=0, keepdims=True))
    S = rng.standard_normal((2, m))
    lam = 0.2 * np.max(np.abs(S @ D))
    cfg = _cfg(maxiters=2000)
    out, jout = _both("lasso_batch", D, S, lam, cfg=cfg)
    assert_same_lanes(out, jout)
    assert_lane_is_solo(out, 1, T.lasso(D, S[1], float(lam), cfg[0], device="cpu"))


def test_lasso_batch_bf16_streams_land_where_serial_bf16_does():
    # The bf16-stream fat branch: the lanes take the plain pair (streams
    # upcast to f32, f32 outputs).  bf16 rounding of b and E b turns the
    # lanes' other summation order (GEMM, not GEMV) into a trajectory of
    # its own at bf16's noise level, and neither stream run meets the stop
    # in 400 steps, so the bar is the optimum: each lane's objective within
    # 1e-3 of the f64 solve's, as the serial bf16 solve's is, and its x no
    # further from the f64 x than 3x the serial bf16 solve's x is.
    D, S = _lasso_instances(B=3, m=32, n=80, seed=4)
    D, S = D.astype(np.float32), S.astype(np.float32)
    lam = 0.1 * float(np.max(np.abs(S @ D)))
    cfg = ADMMConfig(maxiters=400)
    out = T.lasso_batch(D, S, lam, cfg, stream_dtype=torch.bfloat16, device="cpu")
    assert out.xopt.dtype == torch.float32
    for i in range(3):
        solo = T.lasso(D, S[i], lam, cfg, stream_dtype=torch.bfloat16, device="cpu")
        ref = T.lasso(D.astype(np.float64), S[i].astype(np.float64), lam,
                      ADMMConfig(maxiters=4000), device="cpu")
        for run in (float(out.objopt[i]), solo.objopt):
            assert abs(run - ref.objopt) <= 1e-3 * abs(ref.objopt)
        err = lambda x: float((x.double() - ref.xopt).abs().max())  # noqa: E731
        assert err(out.xopt[i]) <= 3 * err(solo.xopt)


def test_lasso_batch_rejects_bad_shapes():
    D, S = _lasso_instances()
    with pytest.raises(ValueError, match="batch"):
        T.lasso_batch(D, S[0], 0.1, device="cpu")
    with pytest.raises(ValueError, match="batch"):
        T.lasso_batch(D, S[:, :-1], 0.1, device="cpu")


def test_basispursuit_batch_matches_serial_per_measurement():
    rng = np.random.default_rng(8)
    m, n, B = 32, 96, 3
    D = rng.standard_normal((m, n))
    X = rng.standard_normal((B, n)) * (rng.random((B, n)) < 0.1)
    S = X @ D.T
    cfg = _cfg(maxiters=3000)
    out, jout = _both("basispursuit_batch", D, S, cfg=cfg)
    assert_same_lanes(out, jout)
    for i in range(B):
        assert_lane_is_solo(out, i, T.basispursuit(D, S[i], cfg[0], device="cpu"))
    assert np.max(np.abs(out.xopt.numpy() @ D.T - S)) < 1e-5


def test_basispursuit_batch_rejects_overdetermined():
    rng = np.random.default_rng(9)
    with pytest.raises(ValueError, match="underdetermined"):
        T.basispursuit_batch(rng.standard_normal((64, 32)), rng.standard_normal((2, 64)),
                             device="cpu")


def test_tv_batch_matches_serial_per_signal():
    rng = np.random.default_rng(3)
    n, B = 128, 3
    steps = np.cumsum(rng.standard_normal((B, 5)), axis=1)
    S = np.repeat(steps, n // 5 + 1, axis=1)[:, :n] + 0.1 * rng.standard_normal((B, n))
    cfg = _cfg(maxiters=2000)
    out, jout = _both("tv_batch", S, 0.5, cfg=cfg)
    assert out.xopt.shape == (B, n)
    assert_same_lanes(out, jout)
    for i in range(B):
        assert_lane_is_solo(out, i, T.totalvariation(S[i], 0.5, cfg[0], device="cpu"))


def test_tv_batch_cr_solver_lanes_agree():
    # solver='cr' at small n: the lanes take the hybrid form (cutoff 1023,
    # here a pure dense tail) as admm_tpu's do; the serial solve the masked
    # form.  Both solve the same system, so lanes and serial agree to the
    # solver's rounding (rtol 1e-9) with equal steps.
    rng = np.random.default_rng(4)
    S = np.cumsum(rng.standard_normal((2, 256)), axis=1)
    cfg = _cfg(maxiters=800)
    out, jout = _both("tv_batch", S, 0.3, cfg=cfg, solver="cr")
    assert_same_lanes(out, jout)
    assert_lane_is_solo(out, 0, T.totalvariation(S[0], 0.3, cfg[0], solver="cr", device="cpu"))


def test_tv_batch_plain_b_phase_is_the_same_run():
    # _plain_cr (the card's control) on the CPU is the very same solve.
    S = np.cumsum(np.random.default_rng(6).standard_normal((3, 300)), axis=1)
    cfg = ADMMConfig(maxiters=300)
    a = T.tv_batch(S, 0.4, cfg, solver="cr", device="cpu")
    b = T.tv_batch(S, 0.4, cfg, solver="cr", device="cpu", _plain_cr=True)
    assert torch.equal(a.steps, b.steps) and torch.equal(a.xopt, b.xopt)
    with pytest.raises(ValueError, match="cyclic-reduction"):
        T.tv_batch(S, 0.4, cfg, solver="dense", device="cpu", _plain_cr=True)


def test_lad_batch_matches_serial_per_rhs():
    D, S = _rhs_instances()
    cfg = _cfg(maxiters=2000)
    out, jout = _both("lad_batch", D, S, cfg=cfg)
    assert_same_lanes(out, jout)
    for i in range(3):
        assert_lane_is_solo(out, i, T.lad(D, S[i], cfg[0], device="cpu"))


def test_huberfit_batch_matches_serial_per_rhs():
    D, S = _rhs_instances(seed=6)
    cfg = _cfg(maxiters=2000)
    out, jout = _both("huberfit_batch", D, S, cfg=cfg)
    assert_same_lanes(out, jout)
    for i in range(3):
        assert_lane_is_solo(out, i, T.huberfit(D, S[i], cfg[0], device="cpu"))


def test_batch_composes_with_engine_variants():
    # Relaxation + unroll through the batched runner stays lane-exact.
    D, S = _rhs_instances(seed=7)
    cfg = _cfg(maxiters=2000, relax=1.3, unroll=4)
    out, jout = _both("lad_batch", D, S, cfg=cfg)
    assert_same_lanes(out, jout)
    assert_lane_is_solo(out, 2, T.lad(D, S[2], cfg[0], device="cpu"))


@pytest.mark.parametrize("method", ["ns", "eigh"])
def test_covsel_batch_matches_serial_per_covariance(method):
    from admm_tpu_torch.models.covarianceselection import empirical_covariance

    rng = np.random.default_rng(13)
    B, m, n = 3, 120, 24
    Ds = rng.standard_normal((B, m, n))
    Ss = np.stack([empirical_covariance(torch.from_numpy(Ds[i])).numpy() for i in range(B)])
    cfg = _cfg(maxiters=400)
    out, jout = _both("covsel_batch", Ss, 0.1, cfg=cfg, prox_method=method)
    assert out.xopt.shape == (B, n, n)
    assert_same_lanes(out, jout)
    for i in range(B):
        solo = T.covarianceselection(Ds[i], 0.1, cfg[0], prox_method=method, device="cpu")
        assert_lane_is_solo(out, i, solo)


def test_covsel_batch_rejects_bad_shapes():
    rng = np.random.default_rng(14)
    with pytest.raises(ValueError, match="stack of covariance"):
        T.covsel_batch(rng.standard_normal((3, 8, 9)), 0.1, device="cpu")


def test_mesh_is_not_ported_and_names_slice_10():
    # mesh= divides the lanes over the mesh: the three mesh tests of
    # tests/test_batch.py (sharded lasso and TV lanes equal to the
    # unsharded run, the divisibility check), on a stacked mesh, where the
    # result is the unsharded run bit for bit
    # (tests/test_torch_ranks_parity.py runs lanes over two processes).
    from admm_tpu_torch.parallel import make_mesh

    D, S = _lasso_instances(B=8)
    lam = 0.1 * np.max(np.abs(S @ D))
    cfg = ADMMConfig(maxiters=2000)
    plain = T.lasso_batch(D, S, lam, cfg, device="cpu")
    sharded = T.lasso_batch(D, S, lam, cfg, device="cpu", mesh=make_mesh(8, device="cpu"))
    assert torch.equal(sharded.xopt, plain.xopt) and torch.equal(sharded.steps, plain.steps)
    jref = J.lasso_batch(D, S, lam, J.ADMMConfig(maxiters=2000),
                         mesh=__import__("admm_tpu.parallel").parallel.make_mesh(8))
    assert_same_lanes(sharded, jref)
    rng = np.random.default_rng(12)
    S2 = np.cumsum(rng.standard_normal((16, 96)), axis=1)
    plain = T.tv_batch(S2, 0.4, ADMMConfig(maxiters=800), device="cpu")
    sharded = T.tv_batch(S2, 0.4, ADMMConfig(maxiters=800), device="cpu",
                         mesh=make_mesh(8, device="cpu"))
    assert torch.equal(sharded.xopt, plain.xopt)
    D3, S3 = _lasso_instances(B=3)
    with pytest.raises(ValueError, match="divide evenly"):
        T.lasso_batch(D3, S3, 0.1, ADMMConfig(maxiters=50), device="cpu",
                      mesh=make_mesh(2, device="cpu"))
    with pytest.raises(ValueError, match="1-axis mesh"):
        T.lad_batch(*_rhs_instances(), device="cpu",
                    mesh=__import__("admm_tpu_torch.parallel").parallel.make_mesh2d(
                        1, 1, device="cpu"))


def test_batch_runner_takes_fresh_data_each_call():
    # admm_tpu caches its compiled vmapped runner across calls
    # (test_batch_runner_is_cached_across_calls); the port compiles
    # nothing, and a second call on fresh data solves the fresh data.
    D, S = _lasso_instances(B=2)
    lam = 0.1 * np.max(np.abs(S @ D))
    cfg = ADMMConfig(maxiters=200)
    T.lasso_batch(D, S, lam, cfg, device="cpu")
    out = T.lasso_batch(D, S + 0.01, lam, cfg, device="cpu")
    for i in range(2):
        assert_lane_is_solo(out, i, T.lasso(D, S[i] + 0.01, float(lam), cfg, device="cpu"))


def test_svm_batch_matches_serial_per_classifier():
    # admm_tpu's lanes start from its jax.random draw, the port's from its
    # own generator (unwrapped.random_start): the two packages are held
    # with the same explicit start, and each port lane against the port's
    # serial solve from its own random start.
    rng = np.random.default_rng(21)
    m, n = 120, 16
    D = rng.standard_normal((m, n))
    y = rng.integers(0, 3, size=m)
    ells = np.stack([np.where(y == k, 1.0, -1.0) for k in range(3)])
    cfg = _cfg(maxiters=400)
    start = dict(x0=rng.random(n), z0=rng.random(m), u0=rng.random(m))
    out, jout = _both("svm_batch", D, ells, 0.5, cfg=cfg, seed=3, **start)
    assert out.xopt.shape == (3, n)
    assert_same_lanes(out, jout)
    own = T.svm_batch(D, ells, 0.5, cfg[0], seed=3, device="cpu")
    for k in range(3):
        assert_lane_is_solo(own, k, T.linearsvm(D, ells[k], 0.5, cfg[0], seed=3, device="cpu"))


def test_svm_batch_per_lane_C_and_01_loss():
    rng = np.random.default_rng(22)
    m, n = 80, 12
    D = rng.standard_normal((m, n))
    ells = np.sign(rng.standard_normal((2, m)))
    Cs = np.array([0.3, 2.0])
    cfg = _cfg(maxiters=300)
    out = T.svm_batch(D, ells, Cs, cfg[0], loss="01", seed=5, device="cpu")
    for k in range(2):
        solo = T.linearsvm(D, ells[k], float(Cs[k]), cfg[0], loss="01", seed=5, device="cpu")
        assert_lane_is_solo(out, k, solo)


def test_svm_batch_rejects_bad_shapes():
    rng = np.random.default_rng(23)
    with pytest.raises(ValueError, match="batch of row instances"):
        T.svm_batch(rng.standard_normal((40, 8)), np.ones((2, 39)), 0.5,
                    ADMMConfig(maxiters=10), device="cpu")


def test_svm_batch_forces_driver_stopping_like_serial():
    rng = np.random.default_rng(74)
    m, n = 60, 10
    D = rng.standard_normal((m, n))
    ells = np.sign(rng.standard_normal((2, m)))
    cfg = ADMMConfig(maxiters=200)
    out = T.svm_batch(D, ells, 0.5, cfg, seed=2, stopcond="standard", nodualerror=False,
                      device="cpu")
    for k in range(2):
        solo = T.linearsvm(D, ells[k], 0.5, cfg, seed=2, stopcond="standard",
                           nodualerror=False, device="cpu")
        assert_lane_is_solo(out, k, solo)


def _lp_instances(B=3, m=20, n=48, seed=31):
    rng = np.random.default_rng(seed)
    D = rng.standard_normal((m, n))
    Ss = np.abs(rng.standard_normal((B, n))) @ D.T
    bs = np.abs(rng.standard_normal((B, n)))
    return D, bs, Ss


def test_lp_batch_matches_serial_per_instance():
    D, bs, Ss = _lp_instances()
    cfg = _cfg(maxiters=500)
    out, jout = _both("lp_batch", bs, D, Ss, cfg=cfg)
    assert out.xopt.shape == (3, 48)
    assert_same_lanes(out, jout)
    for i in range(3):
        assert_lane_is_solo(out, i, T.linearprogram(bs[i], D, Ss[i], cfg[0], device="cpu"))


def test_lp_batch_shared_cost_broadcasts():
    D, bs, Ss = _lp_instances()
    out = T.lp_batch(bs[0], D, Ss, ADMMConfig(maxiters=50), device="cpu")
    assert out.xopt.shape == (3, 48)


def test_lp_batch_rejects_dynamic_rho_and_no_batch_axis():
    D, bs, Ss = _lp_instances()
    with pytest.raises(ValueError, match="fixed rho"):
        T.lp_batch(bs, D, Ss, ADMMConfig(maxiters=50, adaptive=True), device="cpu")
    with pytest.raises(ValueError, match="leading batch axis"):
        T.lp_batch(bs[0], D, Ss[0], ADMMConfig(maxiters=50), device="cpu")


def _qp_standard(seed, B, m, n):
    rng = np.random.default_rng(seed)
    R = rng.standard_normal((n, 2 * n))
    P = R @ R.T / (2 * n) + 0.1 * np.eye(n)
    D = rng.standard_normal((m, n))
    Ss = np.abs(rng.standard_normal((B, n))) @ D.T
    return P, D, Ss, rng.standard_normal((B, n))


def test_qp_batch_standard_matches_serial():
    P, D, Ss, Qs = _qp_standard(33, 3, 12, 32)
    cfg = _cfg(maxiters=400)
    out, jout = _both("qp_batch", P, Qs, 0.0, D, Ss, cfg=cfg)
    assert_same_lanes(out, jout)
    for i in range(3):
        assert_lane_is_solo(out, i, T.quadraticprogram(P, Qs[i], 0.0, D, Ss[i], cfg[0],
                                                       device="cpu"))


def test_qp_batch_bounded_matches_serial():
    rng = np.random.default_rng(34)
    B, n = 4, 24
    R = rng.standard_normal((n, 2 * n))
    P = R @ R.T / (2 * n) + 0.1 * np.eye(n)
    Qs = rng.standard_normal((B, n))
    lbs, ubs = -np.abs(rng.standard_normal((B, n))), np.abs(rng.standard_normal((B, n)))
    rs = rng.standard_normal(B)
    cfg = _cfg(maxiters=400, objevals=True)
    out, jout = _both("qp_batch", P, Qs, rs, lbs, ubs, cfg=cfg, form="bounded")
    assert_same_lanes(out, jout)
    for i in range(B):
        solo = T.quadraticprogram(P, Qs[i], float(rs[i]), lbs[i], ubs[i], cfg[0], device="cpu")
        assert_lane_is_solo(out, i, solo)
        np.testing.assert_allclose(float(out.objopt[i]), solo.objopt, atol=1e-8)


def test_qp_batch_bounded_shared_bounds_auto_detects():
    rng = np.random.default_rng(35)
    n = 16
    out = T.qp_batch(np.eye(n), rng.standard_normal((3, n)), 0.0, -np.ones(n), np.ones(n),
                     ADMMConfig(maxiters=100), device="cpu")
    assert out.xopt.shape == (3, n)
    z = out.zopt.numpy()
    assert np.all(z >= -1 - 1e-9) and np.all(z <= 1 + 1e-9)


def test_qp_batch_rejects_bad_form():
    with pytest.raises(ValueError, match="form must be"):
        T.qp_batch(np.eye(4), np.zeros((2, 4)), 0.0, -np.ones(4), np.ones(4),
                   ADMMConfig(maxiters=10), form="bogus", device="cpu")


def test_batch_warm_start_from_own_solution_restarts_cheaply():
    P, D, Ss, Qs = _qp_standard(51, 3, 10, 24)
    cfg = ADMMConfig(maxiters=500)
    cold = T.qp_batch(P, Qs, 0.0, D, Ss, cfg, device="cpu")
    warm = T.qp_batch(P, Qs, 0.0, D, Ss, cfg, x0=cold.xopt, z0=cold.zopt, u0=cold.uopt,
                      device="cpu")
    assert np.all(warm.steps.numpy() <= 3)
    np.testing.assert_allclose(warm.xopt.numpy(), cold.xopt.numpy(), atol=1e-3)


def test_batch_warm_start_matches_serial_warm_start():
    D, S = _lasso_instances(B=2)
    lam = 0.1 * np.max(np.abs(S @ D))
    X0 = np.random.default_rng(52).standard_normal((2, 96))
    cfg = _cfg(maxiters=300)
    out, jout = _both("lasso_batch", D, S, lam, cfg=cfg, x0=X0, z0=X0, u0=0.1 * X0)
    assert_same_lanes(out, jout)
    for i in range(2):
        solo = T.lasso(D, S[i], float(lam), cfg[0], x0=X0[i], z0=X0[i], u0=0.1 * X0[i],
                       device="cpu")
        assert_lane_is_solo(out, i, solo)


def test_batch_warm_start_broadcasts_single_instance():
    D, S = _lasso_instances(B=3)
    out = T.lasso_batch(D, S, 0.5, ADMMConfig(maxiters=50), x0=np.zeros(96) + 0.5, device="cpu")
    assert out.xopt.shape == (3, 96)
    with pytest.raises(ValueError, match="x0"):
        T.lasso_batch(D, S, 0.5, ADMMConfig(maxiters=50), x0=np.zeros(95), device="cpu")


def test_model_batch_matches_serial_per_rhs_pair():
    rng = np.random.default_rng(55)
    B, mP, mQ, n = 3, 40, 32, 20
    P, Q = rng.standard_normal((mP, n)), rng.standard_normal((mQ, n))
    Rs, Ss = rng.standard_normal((B, mP)), rng.standard_normal((B, mQ))
    cfg = _cfg(maxiters=2000)
    out, jout = _both("model_batch", P, Q, Rs, Ss, cfg=cfg)
    assert out.xopt.shape == (B, n)
    assert_same_lanes(out, jout)
    for i in range(B):
        assert_lane_is_solo(out, i, T.model(P, Q, Rs[i], Ss[i], cfg[0], device="cpu"))


def test_model_batch_shared_s_broadcasts():
    rng = np.random.default_rng(56)
    P, Q = rng.standard_normal((20, 10)), rng.standard_normal((16, 10))
    out = T.model_batch(P, Q, rng.standard_normal((2, 20)), rng.standard_normal(16),
                        ADMMConfig(maxiters=100), device="cpu")
    assert out.xopt.shape == (2, 10)


def test_tv2d_batch_matches_serial_per_image():
    rng = np.random.default_rng(57)
    B, m, n = 3, 12, 16
    Ss = np.kron(rng.standard_normal((B, 3, 4)), np.ones((4, 4))) + 0.1 * rng.standard_normal((B, m, n))
    cfg = _cfg(maxiters=600)
    out, jout = _both("tv2d_batch", Ss, 0.4, cfg=cfg)
    assert out.xopt.shape == (B, m, n)
    assert_same_lanes(out, jout)
    for i in range(B):
        assert_lane_is_solo(out, i, T.totalvariation2d(Ss[i], 0.4, cfg[0], device="cpu"))


def test_tv2d_batch_per_lane_lambda_and_shape_check():
    Ss = np.random.default_rng(58).standard_normal((2, 8, 8))
    out = T.tv2d_batch(Ss, np.array([0.1, 5.0]), ADMMConfig(maxiters=300), device="cpu")
    tv = lambda X: np.abs(np.diff(X, axis=0)).sum() + np.abs(np.diff(X, axis=1)).sum()  # noqa: E731
    assert tv(out.xopt[1].numpy()) < 0.1 * tv(out.xopt[0].numpy())
    with pytest.raises(ValueError, match="stack of images"):
        T.tv2d_batch(Ss[0], 0.1, device="cpu")


def test_qp_batch_bound_stacks_auto_detect_bounded():
    rng = np.random.default_rng(71)
    B = n = 12
    lbs, ubs = -np.abs(rng.standard_normal((B, n))), np.abs(rng.standard_normal((B, n)))
    out = T.qp_batch(np.eye(n), rng.standard_normal((B, n)), 0.0, lbs, ubs,
                     ADMMConfig(maxiters=200), device="cpu")
    z = out.zopt.numpy()
    assert np.all(z >= lbs - 1e-9) and np.all(z <= ubs + 1e-9)


def test_qp_batch_mixed_bound_shapes_error_mentions_bounded():
    rng = np.random.default_rng(72)
    with pytest.raises(ValueError, match="form='bounded'"):
        T.qp_batch(np.eye(12), rng.standard_normal((5, 12)), 0.0,
                   -np.abs(rng.standard_normal((5, 12))), np.ones(12),
                   ADMMConfig(maxiters=10), device="cpu")


def test_qp_structure_reuse_matches_fresh_fold():
    P, D, Ss, Qs = _qp_standard(73, 3, 8, 20)
    cfg = ADMMConfig(maxiters=300)
    fresh = T.qp_batch(P, Qs, 0.0, D, Ss, cfg, device="cpu")
    struct = T.qp_structure(P, D, device="cpu")
    reused = T.qp_batch(P, Qs, 0.0, D, Ss, cfg, structure=struct, device="cpu")
    assert torch.equal(reused.xopt, fresh.xopt)
    n = P.shape[0]
    lb, ub = -np.ones(n), np.ones(n)
    fb = T.qp_batch(P, Qs, 0.0, lb, ub, cfg, device="cpu")
    rb = T.qp_batch(P, Qs, 0.0, lb, ub, cfg, structure=T.qp_structure(P, device="cpu"),
                    device="cpu")
    assert torch.equal(rb.xopt, fb.xopt)
    with pytest.raises(ValueError, match="rho"):
        T.qp_batch(P, Qs, 0.0, D, Ss, ADMMConfig(maxiters=10, rho=2.0), structure=struct,
                   device="cpu")
    with pytest.raises(ValueError, match="conflicts"):
        T.qp_batch(P, Qs, 0.0, lb, ub, cfg, structure=struct, form="bounded", device="cpu")


def test_batch_composes_with_adaptive_rho():
    # Per-lane adaptive rho: each lane walks its own rho trajectory.
    D, S = _lasso_instances(B=3, seed=91)
    lam = 0.1 * np.max(np.abs(S @ D))
    cfg = _cfg(maxiters=2000, adaptive=True, convtest=True)
    out, jout = _both("lasso_batch", D, S, lam, cfg=cfg)
    assert_same_lanes(out, jout)
    np.testing.assert_allclose(out.rho_final.numpy(), np.asarray(jout.rho_final), rtol=1e-12)
    for i in range(3):
        solo = T.lasso(D, S[i], float(lam), cfg[0], device="cpu")
        assert_lane_is_solo(out, i, solo)
        np.testing.assert_allclose(float(out.rho_final[i]), solo.rho_final, rtol=1e-12)


@pytest.mark.parametrize("opts", [
    dict(fast=True, fasttype="strong"),
    dict(fast=True, fasttype="weak", maxiters=400),
    dict(relax=1.5),
    dict(relax=0.8, unroll=4),
    dict(adaptive=True, convtest=True),
    dict(fast=True, fasttype="strong", unroll=4),
    dict(stopcond="hnorm"),
    dict(stopcond="both", unroll=2),
    dict(anderson=4),
])
def test_batch_engine_variant_matrix_matches_serial(opts):
    D, S = _lasso_instances(B=2, seed=101)
    lam = 0.15 * np.max(np.abs(S @ D))
    cfg = _cfg(**{"maxiters": 800, **opts})
    out, jout = _both("lasso_batch", D, S, lam, cfg=cfg)
    assert_same_lanes(out, jout)
    for i in range(2):
        assert_lane_is_solo(out, i, T.lasso(D, S[i], float(lam), cfg[0], device="cpu"))


def test_batch_warm_start_composes_with_fast_mode():
    D, S = _lasso_instances(B=2, seed=102)
    lam = 0.15 * np.max(np.abs(S @ D))
    X0 = np.random.default_rng(103).standard_normal((2, 96))
    cfg = _cfg(maxiters=600, fast=True, fasttype="strong")
    out, jout = _both("lasso_batch", D, S, lam, cfg=cfg, x0=X0, z0=X0, u0=0.0 * X0)
    assert_same_lanes(out, jout)
    for i in range(2):
        solo = T.lasso(D, S[i], float(lam), cfg[0], x0=X0[i], z0=X0[i], u0=0.0 * X0[i],
                       device="cpu")
        assert_lane_is_solo(out, i, solo)


def test_batch_stall_flags_per_lane():
    # f32, as tests/test_batch.py runs it: the plateau flags are per lane,
    # and a lane that stopped writes no more history.  The serial f32 solve
    # stalls too; where the f32 noise plateau trips the window differs
    # between the lanes' and the serial arithmetic, so steps are not held.
    rng = np.random.default_rng(2)
    m, n, B = 24, 96, 3
    D = rng.standard_normal((m, n)).astype(np.float32)
    X = rng.standard_normal((B, n)) * (rng.random((B, n)) < 0.1)
    S = (X @ D.T).astype(np.float32)
    cfg = ADMMConfig(maxiters=3000, abstol=1e-12, reltol=1e-11, stallwindow=60)
    res = T.basispursuit_batch(D, S, cfg, device="cpu")
    st, steps = res.extra["stalled"].numpy(), res.steps.numpy()
    assert st.shape == (B,) and st.all()
    assert (steps < 3000).all()
    for i in range(B):
        solo = T.basispursuit(D, S[i], cfg, device="cpu")
        assert solo.stalled and solo.steps < 3000
        assert np.isnan(res.hist["pnorm"][i, steps[i]:].numpy()).all()


def test_batch_rejects_what_lanes_do_not_run():
    # hooks.fused_zu launches K1 on one instance: the lanes refuse it.  The
    # lanes' quiet=False table runs (test_lanes_table_prints_admm_tpus_rows).
    from admm_tpu_torch.engine import Hooks

    prox = lambda x, z, u, rho: z - u  # noqa: E731
    run = T.make_admm_runner(prox, prox, ADMMConfig(maxiters=10), A=1.0, B=-1.0,
                             hooks=Hooks(fused_zu=lambda x, u, rho: (x, u)), lanes=True)
    x0 = torch.zeros((2, 4), dtype=torch.float64)
    with pytest.raises(NotImplementedError, match="fused_zu"):
        run(x0, x0, x0, 0.0)


@pytest.mark.parametrize("unroll", [1, 4])
def test_lanes_table_prints_admm_tpus_rows(capfd, unroll):
    # Under vmap admm_tpu's lax.cond on the live mask becomes a select, so
    # every lane prints a row at every sub-step the lanes run, a frozen lane
    # the step it would take from its frozen state: the lanes stop at 20,
    # 43 and 24 steps here.  JAX prints the lanes of a sub-step in an order
    # of its own, so the rows are compared as multisets.
    import jax

    rng = np.random.default_rng(0)
    D = rng.standard_normal((12, 24))
    S = rng.standard_normal((3, 12))
    S[1] *= 5
    kw = dict(maxiters=400, abstol=1e-3, reltol=1e-2, quiet=False, unroll=unroll)
    jres = J.lasso_batch(D, S, 0.5, J.ADMMConfig(**kw))
    jax.effects_barrier()
    jrows = capfd.readouterr().out.splitlines()
    res = T.lasso_batch(D, S, 0.5, ADMMConfig(**kw), device="cpu")
    rows = capfd.readouterr().out.splitlines()
    assert res.steps.tolist() == np.asarray(jres.steps).tolist() == [20, 43, 24]
    sub_steps = -(-43 // unroll) * unroll
    assert len(rows) == 3 * sub_steps
    assert sorted(rows) == sorted(jrows)
    assert rows[:3] == [r for r in rows if r.startswith("1\t")]  # lane order in a sub-step
    assert rows.count(next(r for r in rows if r.startswith("21\t"))) >= 43 - 20
