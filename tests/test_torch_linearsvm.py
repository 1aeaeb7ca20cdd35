"""The linear SVM and the serial unwrapped-ADMM solver of the port
(admm_tpu_torch/models/{linearsvm,unwrapped}.py) and the hinge and 0-1
proxes against admm_tpu's on the same numpy inputs in f64.

admm_tpu draws the unwrapped solver's random start from ``jax.random``
and the port from a torch generator, so runs held against admm_tpu pass
x0, z0 and u0 explicitly; the slope oracle of tests/test_linearsvm.py
runs from the port's own start.  With admm_tpu's pinv carried across
(``convert.lasso_data``) the hinge runs agree to the parity bar over
the whole run; the 0-1 prox is nonconvex (one flipped keep-mask entry
parts the trajectories), so its runs are held over a stated number of
steps under ``domaxiters``, step by step through the iterate records."""

import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from admm_tpu import ADMMConfig as JaxConfig
from admm_tpu import linearsvm as jax_linearsvm
from admm_tpu.engine import Hooks as JaxHooks
from admm_tpu.engine import admm as jax_admm
from admm_tpu.models.unwrapped import unwrappedadmm as jax_unwrappedadmm
from admm_tpu.ops import prox as jax_prox
from admm_tpu_torch import (ADMMConfig, Hooks, admm, basispursuit, fusedlasso, huberfit, lad,
                            linearsvm, quantile, unwrappedadmm)
from admm_tpu_torch.convert import lasso_data, numpy_state
from admm_tpu_torch.models.unwrapped import random_start
from admm_tpu_torch.ops.prox import hinge_prox, zero_one_prox

import chip_smoke
from _parity import assert_same_run

torch.set_num_threads(1)
jax_svm_mod = importlib.import_module("admm_tpu.models.linearsvm")
jax_unwrapped_mod = importlib.import_module("admm_tpu.models.unwrapped")
svm_mod = importlib.import_module("admm_tpu_torch.models.linearsvm")
unwrapped_mod = importlib.import_module("admm_tpu_torch.models.unwrapped")

# The unwrapped solver's own defaults, then the relaxed and dynamic-rho
# variants (rbadaptive needs the dual residuals the solver turns off).
_UNWRAPPED = dict(stopcond="both", nodualerror=True)
VARIANTS = {"plain": {}, "relax": {"relax": 1.5},
            "rbadaptive": {"rbadaptive": True, "nodualerror": False}, "unroll": {"unroll": 3}}
ZERO_ONE_STEPS = 300


def _regression_instance(seed=0, m=80, n=12):
    # matrix.py's linear-SVM row at a small size: ell = sign(D w0 + noise).
    rng = np.random.default_rng(seed)
    D = rng.standard_normal((m, n))
    ell = np.sign(D @ rng.standard_normal(n) + 0.1 * rng.standard_normal(m))
    starts = (rng.random(n), rng.random(m), rng.random(m))
    return D, ell, starts


def _carried_runs(loss, cfg, seed=0):
    """admm_tpu's SVM setup plus the pinv its unwrappedadmm takes, run through
    both engines from the same explicit start."""
    D, ell, (x0, z0, u0) = _regression_instance(seed)
    m, n = D.shape
    jcfg = JaxConfig(**cfg)
    _, pg, obj, jdata = jax_svm_mod.make_prox_ops(D, ell, 1.0, loss, jcfg)
    jdata = dict(jdata, Dplus=jnp.linalg.pinv(jnp.asarray(D)))
    jres = jax_admm(jax_unwrapped_mod._prox_f, pg, jcfg, A=jdata["D"], B=-1.0, c=0.0, m=m,
                    nA=n, nB=m, x0=x0, z0=z0, u0=u0, hooks=JaxHooks(obj=obj),
                    dtype=jnp.float64, data=jdata)
    state = numpy_state(jdata, x0=x0, z0=z0, u0=u0)
    assert sorted(state) == ["C", "D", "Dplus", "ell", "u0", "x0", "z0"]
    data, warm = lasso_data(state)
    _, prox_g, obj, _ = svm_mod.make_prox_ops(data["D"], ell, 1.0, loss, ADMMConfig(**cfg))
    res = admm(unwrapped_mod._prox_f, prox_g, ADMMConfig(**cfg), A=data["D"], B=-1.0, c=0.0,
               m=m, nA=n, nB=m, hooks=Hooks(obj=obj), dtype=torch.float64, data=data, **warm)
    return res, jres


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_hinge_iteration_on_carried_state(variant):
    cfg = dict(_UNWRAPPED, maxiters=1000, objevals=True, **VARIANTS[variant])
    res, jres = _carried_runs("hinge", cfg)
    assert 10 < res.steps < 1000
    assert_same_run(res, jres)


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_zero_one_iteration_on_carried_state(variant):
    # Nonconvex: held step by step over ZERO_ONE_STEPS steps, the first
    # step at which the iterates part (a keep mask flipped) printed.
    cfg = dict(_UNWRAPPED, maxiters=ZERO_ONE_STEPS, domaxiters=True, objevals=True,
               record_iterates=True, **VARIANTS[variant])
    res, jres = _carried_runs("01", cfg)
    assert res.steps == jres.steps == ZERO_ONE_STEPS
    z, jz = res.trace("zvals"), jres.trace("zvals")
    apart = np.flatnonzero(np.max(np.abs(z - jz), axis=1) > 1e-9 * np.max(np.abs(jz)))
    print(f"0-1 loss ({variant}): first step whose z differs: "
          f"{apart[0] + 1 if apart.size else 'none'} of {ZERO_ONE_STEPS}")
    assert apart.size == 0
    assert_same_run(res, jres)


@pytest.mark.parametrize("loss", ["hinge", "01"])
def test_linearsvm_matches_jax_f64_from_explicit_starts(loss):
    # Each package takes its own pinv (JAX's default cutoff is
    # 10 max(m, n) eps, torch's max(m, n) eps; D has full rank, so both
    # invert every singular value); the runs agree to ~1e-13 relative.
    D, ell, (x0, z0, u0) = _regression_instance(1)
    cfg = dict(maxiters=1000, objevals=True)
    jres = jax_linearsvm(D, ell, 1.0, JaxConfig(**cfg), loss=loss, x0=x0, z0=z0, u0=u0)
    res = linearsvm(D, ell, 1.0, ADMMConfig(**cfg), loss=loss, x0=x0, z0=z0, u0=u0,
                    device="cpu")
    assert res.config.stopcond == "both" and res.config.nodualerror
    assert_same_run(res, jres)


def test_unwrappedadmm_without_data_matches_jax():
    # The closure form: a user prox_g over the raw x that applies D itself.
    D, _, (x0, z0, u0) = _regression_instance(2)
    Dt = torch.from_numpy(D)

    def prox_g(x, z, u, rho):  # the projection of D x + u onto the box [-1, 1]
        return torch.clamp(Dt @ x + u, -1.0, 1.0)

    def jprox_g(x, z, u, rho):
        return jnp.clip(jnp.asarray(D) @ x + u, -1.0, 1.0)

    cfg = dict(maxiters=500)
    jres = jax_unwrappedadmm(jprox_g, D, JaxConfig(**cfg), x0=x0, z0=z0, u0=u0)
    res = unwrappedadmm(prox_g, D, ADMMConfig(**cfg), x0=x0, z0=z0, u0=u0, device="cpu")
    assert_same_run(res, jres)


@pytest.mark.parametrize("loss", ["hinge", "01"])
def test_svm_recovers_separator_from_the_ports_start(loss):
    # tests/test_linearsvm.py's oracle (slope error <= 0.05 and an
    # objective below the one at x = [1, -1]) on its instance, which
    # chip_smoke.py (y) runs on the card.
    D, ell = chip_smoke.svm_instance(0, 128, 128, 0.5)
    res = linearsvm(D, ell, 1.0, ADMMConfig(objevals=True, maxiters=1000), loss=loss,
                    device="cpu")
    x = res.xopt.numpy()
    assert abs(1.0 - (-x[1] / x[0])) <= 0.05
    f, f_ref = (chip_smoke.family_objective(loss, D, ell, torch.from_numpy(v))
                for v in (x, np.array([1.0, -1.0])))
    assert f < f_ref
    np.testing.assert_allclose(f, res.objopt, rtol=1e-12)  # the port's own _obj_{hinge,01}


def test_random_start_is_the_ports_own():
    x0, z0, u0 = random_start(3, 5, 7, torch.float64, "cpu")
    assert (x0.shape, z0.shape, u0.shape) == ((5,), (7,), (7,))
    allv = torch.cat((x0, z0, u0))
    assert bool(torch.all((allv >= 0) & (allv < 1)))
    again = random_start(3, 5, 7, torch.float64, "cpu")
    assert all(torch.equal(a, b) for a, b in zip((x0, z0, u0), again))
    assert not torch.equal(random_start(4, 5, 7, torch.float64, "cpu")[0], x0)
    # A solve without x0, z0, u0 starts from random_start's draw: its
    # first x-update is D^+ (z0 - u0).
    D, ell, _ = _regression_instance(3)
    res = linearsvm(D, ell, 1.0, ADMMConfig(maxiters=1, domaxiters=True, record_iterates=True),
                    seed=3, device="cpu")
    x0, z0, u0 = random_start(3, 12, 80, torch.float64, "cpu")
    Dplus = torch.linalg.pinv(torch.from_numpy(D))
    np.testing.assert_allclose(res.trace("xvals")[0], (Dplus @ (z0 - u0)).numpy(), rtol=1e-12)


@pytest.mark.parametrize("rho,C", [(1.3, 0.7), (0.2, 2.0)])
def test_zero_one_and_hinge_proxes(rho, C):
    # tests/test_linearsvm.py::test_zero_one_prox_matches_definition
    # (minz01 keeps s where s >= 1 or s < 1 - sqrt(2/t), t = rho/C, else 1)
    # and both proxes against admm_tpu's, with rho and C as floats and as
    # 0-d tensors.
    rng = np.random.default_rng(1)
    Dx_plus_u = rng.standard_normal(64) * 2
    ell = np.sign(rng.standard_normal(64))
    s = ell * Dx_plus_u
    keep = (s >= 1) | (s < 1 - np.sqrt(2 / (rho / C)))
    want = ell * np.where(keep, s, 1.0)
    v, e = torch.from_numpy(Dx_plus_u), torch.from_numpy(ell)
    t = lambda a: torch.tensor(a, dtype=torch.float64)  # noqa: E731
    for c_, r_ in ((C, rho), (t(C), t(rho))):
        np.testing.assert_allclose(zero_one_prox(v, e, c_, r_).numpy(), want, atol=1e-12)
        np.testing.assert_array_equal(zero_one_prox(v, e, c_, r_).numpy(),
                                      np.asarray(jax_prox.zero_one_prox(Dx_plus_u, ell, C, rho)))
        np.testing.assert_array_equal(hinge_prox(v, e, c_, r_).numpy(),
                                      np.asarray(jax_prox.hinge_prox(Dx_plus_u, ell, C, rho)))


def test_only_the_svm_wrappers_refuse_anderson():
    """The unwrapped solver forces stopcond='both', which Anderson
    acceleration refuses (``ADMMConfig``), so linearsvm and unwrappedadmm
    reject ``anderson=`` as admm_tpu's do; every other family of this
    slice takes it."""
    D, ell, _ = _regression_instance(4)
    with pytest.raises(ValueError, match="anderson breaks H-norm") as port:
        linearsvm(D, ell, 1.0, anderson=3, device="cpu")
    with pytest.raises(ValueError) as ref:
        jax_linearsvm(D, ell, 1.0, anderson=3)
    assert str(port.value) == str(ref.value)
    with pytest.raises(ValueError, match="anderson breaks H-norm"):
        unwrappedadmm(lambda x, z, u, rho: z, D, anderson=3, device="cpu")
    rng = np.random.default_rng(4)
    Dfat = rng.standard_normal((12, 40))
    cfg = ADMMConfig(maxiters=40, domaxiters=True, anderson=3)
    for res in (lad(D, ell, cfg, device="cpu"), huberfit(D, ell, cfg, device="cpu"),
                quantile(D, ell, 0.3, cfg, device="cpu"),
                basispursuit(Dfat, Dfat @ rng.standard_normal(40), cfg, device="cpu"),
                fusedlasso(ell, 0.1, 0.2, cfg, device="cpu")):
        assert res.steps == 40 and bool(torch.isfinite(res.xopt).all())


def test_linearsvm_refusals():
    rng = np.random.default_rng(0)
    D = rng.standard_normal((32, 16))
    with pytest.raises(ValueError, match="ell"):
        linearsvm(D, rng.standard_normal(31), 1.0, device="cpu")
    with pytest.raises(NotImplementedError, match="slice 10"):
        linearsvm(D, np.sign(rng.standard_normal(32)), 1.0, parallel=True, device="cpu")
    with pytest.raises(NotImplementedError, match="slice 11"):
        linearsvm()
