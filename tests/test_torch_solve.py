"""Parity of the port's linear-solve caches (admm_tpu_torch/ops/solve.py)
and state conversion (admm_tpu_torch/convert.py) against admm_tpu, in f64
on the same numpy operands."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from admm_tpu import ADMMConfig as JaxConfig
from admm_tpu.models.lasso import make_prox_ops as jax_make_prox_ops
from admm_tpu.ops import solve as jsolve
from admm_tpu_torch import ADMMConfig
from admm_tpu_torch.convert import lasso_data, numpy_state
from admm_tpu_torch.ops import solve as tsolve

torch.set_num_threads(1)

# f64 on both sides; the setup factorizations (eigh, solve) differ in
# their LAPACK paths, which moves results by a few ulps of the condition
# number, well inside these bounds.
RTOL, ATOL = 1e-10, 1e-11


def _operands(seed, m, n):
    rng = np.random.default_rng(seed)
    return rng.standard_normal((m, n)), rng.standard_normal(n)


def _close(t, ref):
    np.testing.assert_allclose(t.numpy(), np.asarray(ref), rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("rho", [0.3, 1.0, 2.7])
def test_sym_shift_solver_matches_jax(rho):
    D, b = _operands(0, 96, 48)
    M = D.T @ D
    j = jsolve.SymShiftSolver.from_matrix(jnp.asarray(M))
    t = tsolve.SymShiftSolver.from_matrix(torch.from_numpy(M))
    _close(t.solve(torch.from_numpy(b), rho), j.solve(jnp.asarray(b), rho))
    _close(t.materialize_inverse(rho), j.materialize_inverse(rho))
    _close(t.w, j.w)


@pytest.mark.parametrize("rho", [0.3, 1.0, 2.7])
def test_woodbury_solver_matches_jax_and_direct(rho):
    D, b = _operands(1, 32, 96)
    j = jsolve.WoodburySolver.from_matrix(jnp.asarray(D))
    t = tsolve.WoodburySolver.from_matrix(torch.from_numpy(D))
    x = t.solve(torch.from_numpy(b), rho)
    _close(x, j.solve(jnp.asarray(b), rho))
    direct = np.linalg.solve(D.T @ D + rho * np.eye(96), b)
    np.testing.assert_allclose(x.numpy(), direct, rtol=1e-9, atol=1e-10)


@pytest.mark.parametrize("rho", [0.3, 1.0, 2.7])
def test_fat_shift_solver_matches_jax_and_direct(rho):
    D, b = _operands(2, 48, 160)
    j = jsolve.FatShiftSolver.from_matrix(jnp.asarray(D), rho)
    t = tsolve.FatShiftSolver.from_matrix(torch.from_numpy(D), rho)
    _close(t.E, j.E)
    x = t.solve(torch.from_numpy(b))
    _close(x, j.solve(jnp.asarray(b)))
    direct = np.linalg.solve(D.T @ D + rho * np.eye(160), b)
    np.testing.assert_allclose(x.numpy(), direct, rtol=1e-8, atol=1e-9)
    assert t.rho0.dtype == torch.float64 and float(t.rho0) == rho


def test_fat_shift_solver_f32_stays_f32():
    D, b = _operands(3, 48, 160)
    t = tsolve.FatShiftSolver.from_matrix(torch.from_numpy(D).float(), 1.0)
    x = t.solve(torch.from_numpy(b).float())
    assert x.dtype == torch.float32 and t.E.dtype == torch.float32
    direct = np.linalg.solve(D.T @ D + np.eye(160), b)
    # f32 setup and apply: relative error of a few f32 ulps times the
    # (small, ~10) condition number of D^T D + I.
    assert np.linalg.norm(x.numpy() - direct) / np.linalg.norm(direct) < 1e-5


def test_bf16_stream_raises_naming_kext1():
    D, _ = _operands(4, 16, 48)
    with pytest.raises(NotImplementedError, match="K-ext-1"):
        tsolve.FatShiftSolver.from_matrix(torch.from_numpy(D), 1.0,
                                          stream_dtype=torch.bfloat16)


@pytest.mark.parametrize("shape", [(48, 160), (96, 48)])  # fat, skinny
def test_convert_round_trips_jax_state(shape):
    D, _ = _operands(5, *shape)
    s = np.random.default_rng(6).standard_normal(shape[0])
    _, _, _, jdata = jax_make_prox_ops(jnp.asarray(D), jnp.asarray(s), 0.2, JaxConfig())
    x0 = np.linspace(-1.0, 1.0, shape[1])
    state = numpy_state(jdata, x0=x0)
    assert set(state) >= {"D", "s", "Dts", "lam", "x0"}
    assert ("fat.E" in state) == (shape[0] < shape[1]) != ("Minv" in state)
    data, warm = lasso_data(state, device="cpu")
    # Bit-for-bit: the port receives exactly admm_tpu's operands (E too).
    for key, val in state.items():
        head, _, field = key.partition(".")
        got = getattr(data[head], field) if field else data.get(key, warm.get(key))
        assert got.dtype == torch.float64
        np.testing.assert_array_equal(got.numpy(), val)
    # And the round trip back reproduces the state.
    back = numpy_state(data, **warm)
    assert set(back) == set(state)
    for key in state:
        np.testing.assert_array_equal(back[key], state[key])
    # The port's own setup agrees with the converted one to solver precision.
    from admm_tpu_torch.models.lasso import make_prox_ops

    _, _, _, tdata = make_prox_ops(torch.from_numpy(D), torch.from_numpy(s), 0.2,
                                   ADMMConfig())
    assert set(tdata) == set(data)
    if "fat" in data:
        _close(tdata["fat"].E, state["fat.E"])
    else:
        _close(tdata["Minv"], state["Minv"])


def test_convert_refuses_adaptive_state():
    D, _ = _operands(7, 16, 48)
    cfg = JaxConfig(adaptive=True, convtest=True)
    _, _, _, jdata = jax_make_prox_ops(jnp.asarray(D), jnp.zeros(16), 0.2, cfg)
    with pytest.raises(ValueError, match="wood"):
        numpy_state(jdata)
