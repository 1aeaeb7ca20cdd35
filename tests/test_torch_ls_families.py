"""Elastic net, NNLS and group lasso of the port
(admm_tpu_torch/models/{elasticnet,nnls,grouplasso}.py) against admm_tpu's
own solvers on the same numpy inputs, each package doing its own setup:
f64 step counts, iterates and objective histories; bf16 streams in f32;
``resolve_groups``'s validation; and the bf16 warm start + f32 polish
recipe of tests/test_mixed_precision.py run through the port."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import admm_tpu
from admm_tpu import ADMMConfig as JaxConfig
from admm_tpu.models.grouplasso import resolve_groups as jax_resolve_groups
from admm_tpu_torch import ADMMConfig, Hooks, admm, elasticnet, grouplasso, lasso, nnls
from admm_tpu_torch.models.grouplasso import resolve_groups
from admm_tpu_torch.models.lasso import make_prox_ops
from admm_tpu_torch.ops.gemv_pair import gemv_pair

torch.set_num_threads(1)

_PORT = {"elasticnet": elasticnet, "nnls": nnls, "grouplasso": grouplasso, "lasso": lasso}


def _instance(seed, rows, cols, dtype=np.float64):
    # tests/test_lasso.py's generator.
    rng = np.random.default_rng(seed)
    testx = rng.standard_normal(cols) * (rng.random(cols) < 0.4)
    D = rng.standard_normal((rows, cols))
    D = D / np.sqrt(np.sum(D**2, axis=0, keepdims=True))
    s = D @ testx + np.sqrt(0.001) * rng.standard_normal(rows)
    lam = float(0.1 * np.max(np.abs(D.T @ s)))
    return D.astype(dtype), s.astype(dtype), lam


def _args(family, D, s, lam):
    """Positional arguments after (D, s) for each family."""
    n = D.shape[1]
    if family == "elasticnet":
        return (lam, 0.5)
    if family == "nnls":
        return ()
    if family == "grouplasso":
        lengths = [n // 4, n // 4 + 3, n - 2 * (n // 4) - 3]  # uneven groups
        return (lam, lengths, np.sqrt(lengths))
    return (lam,)


def _solve(pkg, family, D, s, lam, cfg, **kw):
    fn = getattr(admm_tpu, family) if pkg == "jax" else _PORT[family]
    Config = JaxConfig if pkg == "jax" else ADMMConfig
    if pkg != "jax":
        kw["device"] = "cpu"
    return fn(D, s, *_args(family, D, s, lam), config=Config(**cfg), **kw)


@pytest.mark.parametrize("family", ["elasticnet", "nnls", "grouplasso"])
@pytest.mark.parametrize("rows,cols", [(96, 48), (48, 120)])  # skinny, fat
def test_family_matches_jax_f64(family, rows, cols):
    D, s, lam = _instance(1, rows, cols)
    cfg = dict(maxiters=3000, objevals=True, unroll=4)
    jres = _solve("jax", family, D, s, lam, cfg)
    res = _solve("port", family, D, s, lam, cfg)
    assert res.steps == jres.steps < 3000
    assert res.xopt.dtype == torch.float64
    # Each package factorizes on its own (eigh / solve in f64), so the
    # iterates agree to the conditioning of the setup, not bit for bit.
    for name in ("xopt", "zopt", "uopt"):
        np.testing.assert_allclose(getattr(res, name).numpy(),
                                   np.asarray(getattr(jres, name)),
                                   rtol=1e-9, atol=1e-10)
    for name in ("pnorm", "dnorm", "objvals"):
        ref = jres.trace(name)
        np.testing.assert_allclose(res.trace(name), ref, rtol=0, atol=1e-8 * abs(ref[0]))


def test_group_specs_and_weights_match_jax_f64():
    D, s, lam = _instance(2, 40, 60)
    ids = np.arange(60) % 7  # ids, not consecutive
    cfg = dict(maxiters=3000)
    for groups, weights in ((12, None), (ids, np.linspace(0.5, 2.0, 7))):
        jres = admm_tpu.grouplasso(D, s, lam, groups, weights, JaxConfig(**cfg))
        res = grouplasso(D, s, lam, groups, weights, ADMMConfig(**cfg), device="cpu")
        assert res.steps == jres.steps < 3000
        np.testing.assert_allclose(res.zopt.numpy(), np.asarray(jres.zopt),
                                   rtol=1e-9, atol=1e-10)


def test_elasticnet_alpha_one_is_lasso_bit_for_bit():
    # lam*1 and 1 + lam*0/rho are exact, so the z-prox is lasso's.
    D, s, lam = _instance(3, 48, 120)
    cfg = ADMMConfig(maxiters=3000)
    a = elasticnet(D, s, lam, 1.0, cfg, device="cpu")
    b = lasso(D, s, lam, cfg, device="cpu")
    assert a.steps == b.steps and torch.equal(a.xopt, b.xopt)


@pytest.mark.parametrize("family", ["lasso", "elasticnet", "nnls", "grouplasso"])
def test_bf16_streams_match_jax_f32(family, monkeypatch):
    monkeypatch.setattr(gemv_pair, "launches", 0)
    D, s, lam = _instance(4, 48, 160, np.float32)
    cfg = dict(maxiters=20, domaxiters=True, unroll=4)
    jres = _solve("jax", family, D, s, lam, cfg, stream_dtype=jnp.bfloat16)
    res = _solve("port", family, D, s, lam, cfg, stream_dtype=torch.bfloat16)
    assert res.steps == jres.steps == 20 and res.xopt.dtype == torch.float32
    assert gemv_pair.launches == 0  # the CPU runs the plain version
    # The same bf16 operands and rounding points, but XLA and PyTorch add
    # the f32 products in other orders, so now and then a product lands on
    # the other side of a bf16 rounding (2^-8 relative), and the iteration
    # carries that on at bf16's noise level.  Measured here: <= 7e-6 for
    # lasso, nnls and group lasso, 7.4e-3 for elastic net (one such flip
    # by step 5); bf16 against f32 streams differs by 0.8-3e-2.
    ref = np.asarray(jres.zopt)
    assert np.linalg.norm(res.zopt.numpy() - ref) <= 1e-2 * np.linalg.norm(ref)
    # And bf16 streams do change the iterate against f32 streams.
    f32 = _solve("port", family, D, s, lam, cfg)
    assert not torch.equal(f32.zopt, res.zopt)


@pytest.mark.parametrize("groups,match", [
    (7, "do not tile"),
    (0, "do not tile"),
    (np.zeros((2, 15), int), "must be 1-D"),
    ([10, 10], "positive and sum to n=30"),
    ([10, 25, -5], "positive and sum to n=30"),
    (np.r_[np.zeros(15, int), np.full(15, 2)], "contiguously"),
    (np.ones(30, int), "look like group LENGTHS"),
])
def test_resolve_groups_refuses_like_jax(groups, match):
    with pytest.raises(ValueError, match=match) as port:
        resolve_groups(groups, 30)
    with pytest.raises(ValueError) as ref:
        jax_resolve_groups(groups, 30)
    assert str(port.value) == str(ref.value)


def test_resolve_groups_resolves_like_jax():
    for groups in (5, [10, 20], np.r_[np.zeros(6, int), np.ones(24, int)], np.arange(30) % 4):
        gid, num = resolve_groups(groups, 30)
        jgid, jnum = jax_resolve_groups(groups, 30)
        assert num == jnum and gid.dtype == np.int64
        np.testing.assert_array_equal(gid, np.asarray(jgid))


def test_grouplasso_checks_weights_shape():
    D, s, lam = _instance(5, 20, 30)
    with pytest.raises(ValueError, match=r"weights must have shape \(3,\)"):
        grouplasso(D, s, lam, 3, np.ones(4), device="cpu")


def test_bf16_warmstart_plus_f32_polish_recovers_accuracy():
    # tests/test_mixed_precision.py's recipe, through the port.
    rng = np.random.default_rng(0)
    m, n = 48, 160  # fat branch (where bf16 streams apply)
    D = (rng.standard_normal((m, n)) / 7).astype(np.float32)
    tx = (rng.standard_normal(n) * (rng.random(n) < 0.2)).astype(np.float32)
    s = (D @ tx + 0.01 * rng.standard_normal(m)).astype(np.float32)
    lam = float(0.1 * np.max(np.abs(D.T @ s)))

    def obj(x):
        x = x.numpy()
        return 0.5 * np.sum((D @ x - s) ** 2) + lam * np.sum(np.abs(x))

    exact = lasso(D, s, lam, ADMMConfig(maxiters=5000), device="cpu")
    coarse = lasso(D, s, lam, ADMMConfig(maxiters=5000), stream_dtype=torch.bfloat16,
                   device="cpu")
    pf, pg, objfn, data = make_prox_ops(torch.from_numpy(D), torch.from_numpy(s), lam,
                                        ADMMConfig())
    polished = admm(pf, pg, ADMMConfig(maxiters=200), A=1.0, B=-1.0, c=0.0, m=n,
                    x0=coarse.xopt, z0=coarse.zopt, u0=coarse.uopt,
                    hooks=Hooks(obj=objfn), data=data)
    gap_coarse = abs(obj(coarse.xopt) - obj(exact.xopt))
    gap_polished = abs(obj(polished.xopt) - obj(exact.xopt))
    assert polished.steps <= 200
    assert gap_polished <= max(0.2 * gap_coarse, 1e-7)
