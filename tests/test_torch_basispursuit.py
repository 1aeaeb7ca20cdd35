"""Basis pursuit of the port (admm_tpu_torch/models/basispursuit.py)
against admm_tpu's on the same numpy inputs in f64: on admm_tpu's setup
carried across (``convert.model_data``, whose state P leads) to isolate the iteration,
with each package doing its own setup (Cholesky and the projection), and
the reference tester's oracle (tests/test_basispursuit.py) run through the
port."""

import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from admm_tpu import ADMMConfig as JaxConfig
from admm_tpu import basispursuit as jax_bp
from admm_tpu.engine import Hooks as JaxHooks
from admm_tpu.engine import admm as jax_admm
from admm_tpu_torch import ADMMConfig, Hooks, admm, basispursuit
from admm_tpu_torch.convert import model_data, numpy_state

from _parity import assert_same_run

torch.set_num_threads(1)
jax_bp_mod = importlib.import_module("admm_tpu.models.basispursuit")
bp_mod = importlib.import_module("admm_tpu_torch.models.basispursuit")

# The relaxed and the dynamic-rho variants beside the plain one; unroll 3
# freezes sub-steps past the stop.
VARIANTS = {"plain": {}, "relax": {"relax": 1.5}, "rbadaptive": {"rbadaptive": True},
            "unroll": {"unroll": 3}}


def _instance(seed, rows, cols, density=0.1):
    # tests/test_basispursuit.py's generator.
    rng = np.random.default_rng(seed)
    D = rng.standard_normal((rows, cols))
    testx = rng.standard_normal(cols) * (rng.random(cols) < density)
    return D, D @ testx, testx


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_basispursuit_iteration_on_carried_state(variant):
    D, s, _ = _instance(3, 24, 96)
    n = D.shape[1]
    cfg = dict(maxiters=3000, objevals=True, **VARIANTS[variant])
    jcfg = JaxConfig(**cfg)
    pf, pg, obj, jdata = jax_bp_mod.make_prox_ops(D, s, jcfg)
    jres = jax_admm(pf, pg, jcfg, A=1.0, B=-1.0, c=0.0, m=n, nA=n, nB=n,
                    hooks=JaxHooks(obj=obj), dtype=jnp.float64, data=jdata)
    state = numpy_state(jdata)
    assert sorted(state) == ["P", "q"]
    data, warm = model_data(state)
    assert warm == {} and data["P"].dtype == torch.float64
    res = admm(bp_mod._prox_f, bp_mod._prox_g, ADMMConfig(**cfg), A=1.0, B=-1.0, c=0.0,
               m=n, nA=n, nB=n, hooks=Hooks(obj=bp_mod._obj), dtype=torch.float64, data=data)
    assert res.steps < 3000
    assert_same_run(res, jres)


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_basispursuit_matches_jax_f64(variant):
    # Each package runs its own Cholesky and projection in f64; the runs
    # agree to ~1e-14 relative, held to the parity bar.
    D, s, _ = _instance(0, 32, 128)
    cfg = dict(maxiters=3000, objevals=True, **VARIANTS[variant])
    jres = jax_bp(D, s, JaxConfig(**cfg))
    res = basispursuit(D, s, ADMMConfig(**cfg), device="cpu")
    assert res.xopt.dtype == torch.float64 and res.xopt.device.type == "cpu"
    assert_same_run(res, jres)
    np.testing.assert_allclose(res.objopt, jres.objopt, rtol=1e-10)


def test_projection_matches_jax():
    D, s, _ = _instance(4, 20, 50)
    *_, jdata = jax_bp_mod.make_prox_ops(D, s)
    *_, data = bp_mod.make_prox_ops(torch.from_numpy(D), torch.from_numpy(s))
    for key in ("P", "q"):
        np.testing.assert_allclose(data[key].numpy(), np.asarray(jdata[key]), rtol=0,
                                   atol=1e-12)
    # P projects onto the null space of D, and q solves D q = s.
    np.testing.assert_allclose(D @ data["P"].numpy(), 0.0, atol=1e-12)
    np.testing.assert_allclose(D @ data["q"].numpy(), s, atol=1e-12)


@pytest.mark.parametrize("seed,rows,cols", [(0, 32, 128), (1, 64, 256)])
def test_basispursuit_recovers_sparse_solution(seed, rows, cols):
    # tests/test_basispursuit.py's oracle (testers/basispursuittest.m).
    D, s, testx = _instance(seed, rows, cols)
    res = basispursuit(D, s, ADMMConfig(objevals=True, maxiters=10000, abstol=1e-9,
                                        reltol=1e-8), device="cpu")
    xopt = res.xopt.numpy()
    assert np.sum(np.abs(testx)) >= np.sum(np.abs(xopt)) - 1e-8
    assert np.linalg.norm(D @ xopt - s) <= 1e-10 * max(np.linalg.norm(s), 1.0)


def test_basispursuit_f32_on_tensors():
    # admm_tpu/benchmarks/matrix.py's f32 oracle settings and bar (1e-4),
    # held against the same solve in f64.
    D, s, _ = _instance(2, 32, 128)
    D32, s32 = torch.from_numpy(D.astype(np.float32)), torch.from_numpy(s.astype(np.float32))
    cfg = ADMMConfig(maxiters=10000, abstol=1e-7, reltol=1e-6, stallwindow=100)
    res = basispursuit(D32, s32, cfg)
    ref = basispursuit(D32.double(), s32.double(), cfg).xopt.numpy()
    assert res.xopt.dtype == torch.float32 and res.steps < 10000
    assert np.linalg.norm(res.xopt.numpy() - ref) <= 1e-4 * np.linalg.norm(ref)


def test_basispursuit_refuses_what_the_reference_refuses():
    rng = np.random.default_rng(0)
    D = rng.standard_normal((64, 32))
    with pytest.raises(ValueError, match="underdetermined") as port:
        basispursuit(D, rng.standard_normal(64), device="cpu")
    with pytest.raises(ValueError) as ref:
        jax_bp(D, rng.standard_normal(64))
    assert str(port.value) == str(ref.value)
    with pytest.raises(ValueError, match="vector of length 64"):
        basispursuit(D, rng.standard_normal(63), device="cpu")
    with pytest.raises(NotImplementedError, match="slice 11"):
        basispursuit()
