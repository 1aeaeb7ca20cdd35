"""The whole slice: the port's ``lasso`` (admm_tpu_torch/models/lasso.py)
against admm_tpu's own ``lasso`` on the same numpy inputs, each package
doing its own setup, plus the port's headline benchmark at smoke size."""

import json

import numpy as np
import pytest
import torch

from admm_tpu import ADMMConfig as JaxConfig
from admm_tpu import lasso as jax_lasso
from admm_tpu_torch import ADMMConfig, lasso
from admm_tpu_torch.ops.kernels import fused_soft_threshold_dual

torch.set_num_threads(1)

HIST = ("pnorm", "dnorm", "perr", "derr")


def _make_instance(seed, rows, cols, density=0.6):
    # tests/test_lasso.py's generator.
    rng = np.random.default_rng(seed)
    testx = rng.standard_normal(cols) * (rng.random(cols) < density)
    D = rng.standard_normal((rows, cols))
    D = D / np.sqrt(np.sum(D**2, axis=0, keepdims=True))
    s = D @ testx + np.sqrt(0.001) * rng.standard_normal(rows)
    lam = 0.1 * np.max(np.abs(D.T @ s))
    return D, s, lam


@pytest.mark.parametrize("seed,rows,cols,fused", [
    (0, 128, 64, False),   # skinny: materialized (D^T D + rho I)^{-1}
    (2, 64, 128, False),   # fat: FatShiftSolver
    (2, 64, 128, True),    # fat, fused z/u pass
    (3, 64, 128, True),
])
def test_lasso_matches_jax_f64(seed, rows, cols, fused):
    D, s, lam = _make_instance(seed, rows, cols)
    cfg = dict(maxiters=5000, objevals=True, unroll=4)
    jres = jax_lasso(D, s, lam, JaxConfig(**cfg), use_fused_kernel=fused)
    res = lasso(D, s, lam, ADMMConfig(**cfg), use_fused_kernel=fused)
    assert res.steps == jres.steps < 5000
    assert res.xopt.dtype == torch.float64 and res.xopt.device.type == "cpu"
    # Each package factorizes on its own (eigh / solve in f64), so the
    # iterates agree to the conditioning of the setup, not bit for bit.
    for name in ("xopt", "zopt", "uopt"):
        np.testing.assert_allclose(getattr(res, name).numpy(),
                                   np.asarray(getattr(jres, name)),
                                   rtol=1e-9, atol=1e-10)
    for name in HIST + ("objvals",):
        ref = jres.trace(name)
        np.testing.assert_allclose(res.trace(name), ref, rtol=0,
                                   atol=1e-8 * abs(ref[0]))
    np.testing.assert_allclose(res.objopt, jres.objopt, rtol=1e-10)


def test_lasso_matches_jax_f32():
    # f32 on both sides, fixed step count (domaxiters) so that a stop
    # decided by one rounding cannot split the runs.  XLA and PyTorch sum
    # the GEMVs in different orders, so the iterates differ by f32
    # rounding (eps 1.2e-7) amplified by the slowly contracting ADMM map;
    # 2e-5 relative to max|x| is ~170 ulps, far below any algorithmic
    # difference (a wrong branch or update moves x by O(1e-2) or more).
    D, s, lam = _make_instance(2, 64, 128)
    D, s = D.astype(np.float32), s.astype(np.float32)
    cfg = dict(maxiters=200, domaxiters=True, unroll=8)
    jres = jax_lasso(D, s, lam, JaxConfig(**cfg), use_fused_kernel=True)
    res = lasso(D, s, lam, ADMMConfig(**cfg), use_fused_kernel=True)
    assert res.steps == jres.steps == 200
    assert res.xopt.dtype == torch.float32
    scale = float(np.max(np.abs(np.asarray(jres.xopt))))
    for name in ("xopt", "zopt", "uopt"):
        np.testing.assert_allclose(getattr(res, name).numpy(),
                                   np.asarray(getattr(jres, name)),
                                   rtol=0, atol=2e-5 * scale)


def test_lasso_fused_and_plain_agree_f64():
    D, s, lam = _make_instance(1, 64, 160)
    cfg = ADMMConfig(maxiters=5000, unroll=16)
    a = lasso(D, s, lam, cfg, use_fused_kernel=True)
    b = lasso(D, s, lam, cfg, use_fused_kernel=False)
    assert a.steps == b.steps
    np.testing.assert_allclose(a.xopt.numpy(), b.xopt.numpy(), rtol=1e-12, atol=1e-13)


def test_lasso_accepts_tensors_and_keeps_their_device():
    D, s, lam = _make_instance(0, 96, 48)
    res = lasso(torch.from_numpy(D), torch.from_numpy(s), lam,
                ADMMConfig(maxiters=3000))
    ref = lasso(D, s, lam, ADMMConfig(maxiters=3000))
    assert res.steps == ref.steps
    assert torch.equal(res.xopt, ref.xopt)
    assert res.solverruntime >= res.runtime > 0


def test_precision_pin_restores_callers_setting():
    D, s, lam = _make_instance(2, 64, 128)
    old = torch.get_float32_matmul_precision()
    torch.set_float32_matmul_precision("medium")
    try:
        seen = []

        def spy(x, z, u, rho, d):
            seen.append((torch.get_float32_matmul_precision(),
                         torch.backends.cuda.matmul.allow_tf32))
            return d["fat"].solve(d["Dts"] + rho * (z - u))

        from admm_tpu_torch.engine import Hooks, admm
        from admm_tpu_torch.models.lasso import _prox_g, make_prox_ops

        cfg = ADMMConfig(maxiters=3, domaxiters=True)
        _, _, _, data = make_prox_ops(torch.from_numpy(D), torch.from_numpy(s), lam, cfg)
        admm(spy, _prox_g, cfg, m=128, data=data, hooks=Hooks(), dtype=torch.float64)
        assert seen == [("highest", False)] * 3
        admm(spy, _prox_g, ADMMConfig(maxiters=1, matmul_precision="high"), m=128,
             data=data, dtype=torch.float64)
        assert seen[-1] == ("high", True)
        lasso(D, s, lam, ADMMConfig(maxiters=5))
        assert torch.get_float32_matmul_precision() == "medium"
    finally:
        torch.set_float32_matmul_precision(old)


@pytest.mark.parametrize("kw,exc,match", [
    (dict(parallel=True), NotImplementedError, "slice 10"),
    (dict(stream_dtype=torch.bfloat16), NotImplementedError, "K-ext-1"),
    (dict(adaptive=True, convtest=True), NotImplementedError, "slice 2"),
    (dict(rbadaptive=True), NotImplementedError, "slice 2"),
])
def test_unported_lasso_modes_raise(kw, exc, match):
    D, s, lam = _make_instance(2, 32, 64)
    with pytest.raises(exc, match=match):
        lasso(D, s, lam, **kw)


def test_lasso_demo_mode_raises():
    with pytest.raises(NotImplementedError, match="slice 11"):
        lasso()


def test_lasso_checks_shapes():
    with pytest.raises(ValueError, match="rows of D"):
        lasso(np.zeros((4, 6)), np.zeros(5), 0.1)


# admm_tpu/benchmarks/headline.py's keys, plus the port's two additions.
_HEADLINE_KEYS = {
    "metric", "platform", "value", "unit", "vs_baseline",
    "maxiters_per_dispatch", "dispatch_floor_ms", "marginal_iter_s",
    "numpy_baseline_iters_per_sec", "bf16_stream_iters_per_sec",
    "steps_to_rms_residual_1e-6", "time_to_rms_residual_1e-6_s",
    "baseline_time_to_rms_residual_1e-6_s",
}


def test_headline_smoke_prints_the_same_keys(capsys, monkeypatch):
    from admm_tpu_torch.benchmarks import headline

    monkeypatch.setattr(fused_soft_threshold_dual, "launches", 0)
    line = headline.main(smoke=True, device="cpu")
    printed = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert printed == line
    assert set(line) == _HEADLINE_KEYS | {"device", "fused_vs_plain_max_abs_diff"}
    assert line["device"] == "cpu" and line["platform"] == "cpu"
    assert line["maxiters_per_dispatch"] == 100
    # The smoke problem reaches the RMS target well inside 100 steps.
    assert 10 < line["steps_to_rms_residual_1e-6"] < 100
    assert 0 <= line["fused_vs_plain_max_abs_diff"] < 1e-5
    assert fused_soft_threshold_dual.launches == 0  # CPU: the plain version
