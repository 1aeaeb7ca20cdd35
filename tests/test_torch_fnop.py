"""Matrix-free constraint operators of the port (admm_tpu_torch/linop.FnOp)
— the reference's function-handle A with explicit nA (admm.m:121-130) —
against admm_tpu's FnOp in f64 (tests/test_fnop.py's engine case)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from admm_tpu import ADMMConfig as JaxConfig
from admm_tpu import FnOp as JaxFnOp
from admm_tpu import admm as jax_admm
from admm_tpu.ops.prox import soft_threshold as jax_soft_threshold
from admm_tpu_torch import ADMMConfig, FnOp, admm
from admm_tpu_torch.linop import as_linop
from admm_tpu_torch.ops.prox import soft_threshold

torch.set_num_threads(1)


def _scale_mv(v, alpha):
    return alpha * v


def _solve(pkg, s, alpha, cfg_kw, A=None):
    """min 1/2||x - s||^2 + ||z||_1  s.t.  alpha x - z = 0, with A a FnOp
    (or the given A), through either package."""
    n = s.shape[0]
    if pkg == "jax":
        s, a = jnp.asarray(s), jnp.asarray(alpha)
        shrink, Op, run, Config, kw = jax_soft_threshold, JaxFnOp, jax_admm, JaxConfig, {}
        dt = jnp.float64
    else:
        s, a = torch.from_numpy(s), torch.tensor(alpha, dtype=torch.float64)
        # The operands hide in the closures: the device is named.
        shrink, Op, run, Config, kw = soft_threshold, FnOp, admm, ADMMConfig, {"device": "cpu"}
        dt = torch.float64

    def prox_f(x, z, u, rho):
        # argmin 1/2||x-s||^2 + rho/2 ||alpha x - z + u||^2
        return (s + alpha * rho * (z - u)) / (1.0 + alpha * alpha * rho)

    def prox_g(x, z, u, rho):
        return shrink(alpha * x + u, 1.0 / rho)

    A = Op(_scale_mv, _scale_mv, data=(a,)) if A is None else A
    return run(prox_f, prox_g, Config(**cfg_kw), A=A, B=-1.0, c=0.0, m=n, nA=n, nB=n,
               dtype=dt, **kw)


def test_fnop_as_engine_constraint():
    """A = 3 I as a matrix-free callable pair; the oracle is the closed
    form x = sign(s) max(|s| - 3, 0)."""
    s = np.random.default_rng(0).standard_normal(32)
    res = _solve("torch", s, 3.0, dict(maxiters=3000))
    expected = np.sign(s) * np.maximum(np.abs(s) - 3.0, 0.0)
    np.testing.assert_allclose(res.xopt.numpy(), expected, atol=1e-4)
    jres = _solve("jax", s, 3.0, dict(maxiters=3000))
    assert res.steps == jres.steps < 3000
    for name in ("xopt", "zopt", "uopt"):
        np.testing.assert_allclose(getattr(res, name).numpy(), np.asarray(getattr(jres, name)),
                                   rtol=1e-9, atol=1e-10)
    for name in ("pnorm", "dnorm", "perr", "derr"):
        ref = jres.trace(name)
        np.testing.assert_allclose(res.trace(name), ref, rtol=0, atol=1e-8 * abs(ref[0]))


@pytest.mark.parametrize("cfg_kw", [dict(maxiters=400, relax=1.5),
                                    dict(maxiters=400, stopcond="both", convtest=True)])
def test_fnop_equals_the_dense_operator(cfg_kw):
    # The same constraint as a FnOp and as a dense matrix: the same run, up
    # to the matrix product's rounding of alpha x.
    s = np.random.default_rng(1).standard_normal(24) * 3.0
    alpha = 2.0
    via_fn = _solve("torch", s, alpha, cfg_kw)
    via_dense = _solve("torch", s, alpha, cfg_kw, A=alpha * np.eye(24))
    assert via_fn.steps == via_dense.steps
    np.testing.assert_allclose(via_fn.xopt.numpy(), via_dense.xopt.numpy(), rtol=1e-12,
                               atol=1e-14)


def test_fnop_protocol_and_size_rule():
    op = FnOp(_scale_mv, _scale_mv, data=(torch.tensor(2.0),))
    assert as_linop(op) is op and op.out_shape((5,)) is None
    v = torch.arange(4.0)
    assert torch.equal(op.mv(v), 2.0 * v) and torch.equal(op.rmv(v), 2.0 * v)
    assert "FnOp" in repr(op)
    # A scalar c with a matrix-free A needs m (admm.m:99-110).
    with pytest.raises(ValueError, match="provide m"):
        admm(lambda *a: a[0], lambda *a: a[0], ADMMConfig(maxiters=2), A=op, B=-1.0,
             nA=4, nB=4, device="cpu", dtype=torch.float64)
