"""The GEMV pair (K2) and the resident fat-LASSO iteration (K3) of the
port (admm_tpu_torch/ops/gemv_pair.py), the bf16-stream FatShiftSolver
that runs on K2, and the two experiment probes, against admm_tpu on the
CPU, where the wrappers run their plain PyTorch versions.

The TPU experiments themselves (experiments/pallas_probe.py,
experiments/resident_iter_proto.py) build their full-size operands and
launch Pallas TPU kernels when they are imported, so no test can import
them: the JAX expressions of their kernels' bodies are written out here
(pallas_probe.py:38-46) or taken from admm_tpu's engine, whose fused
LASSO step is the prototype's body (resident_iter_proto.py:51-67)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from admm_tpu import ADMMConfig as JaxConfig
from admm_tpu import lasso as jax_lasso
from admm_tpu.models.lasso import make_prox_ops as jax_make_prox_ops
from admm_tpu_torch import ADMMConfig, lasso
from admm_tpu_torch.convert import lasso_data, numpy_state
from admm_tpu_torch.experiments import gemv_pair_probe, resident_iter_proto
from admm_tpu_torch.ops.gemv_pair import gemv_pair, resident_lasso
from admm_tpu_torch.ops.solve import FatShiftSolver

torch.set_num_threads(1)

_JAX_DTYPES = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16}


def _jax_pair(b, En, Dm, dtype, K):
    """K steps of pallas_probe.py's body on a vector b."""
    x = jnp.asarray(b)
    for _ in range(K):
        t = jnp.dot(x.astype(dtype), En, preferred_element_type=jnp.float32)
        x = jnp.dot(t.astype(dtype), Dm, preferred_element_type=jnp.float32)
    return np.asarray(x)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("K", [1, 4])
@pytest.mark.parametrize("m,n", [(7, 33), (48, 160)])
def test_gemv_pair_plain_version_matches_jax(dtype, K, m, n):
    b, E, Dt = gemv_pair_probe.make_operands(m, n, torch.device("cpu"), dtype)
    x = gemv_pair(b, E, Dt, K)
    assert x.dtype == torch.float32 and x.shape == (n,)
    jdt = _JAX_DTYPES[dtype]
    ref = _jax_pair(b.float().numpy(), jnp.asarray(E.float().numpy().T, jdt),
                    jnp.asarray(Dt.float().numpy().T, jdt), jdt, K)
    # The same operands and rounding points; XLA and PyTorch add the f32
    # products in other orders: a few f32 ulps per product (measured up to
    # 3.7e-7 at K = 1 and 8.1e-7 at K = 4).  In bf16 that could move a
    # rounding of t or b to the neighbouring bf16 value (2^-8 relative);
    # none of these draws does (measured <= 1e-7), so bf16 keeps the bar.
    bar = 1e-6 if K == 1 else 4e-6
    np.testing.assert_allclose(x.numpy(), ref, rtol=0, atol=bar * np.max(np.abs(ref)))


def test_gemv_pair_rounds_where_jax_rounds():
    # One product whose exact t = 1 + 2^-8 + 2^-10 lies between two bf16
    # values: both round it up to 1 + 2^-7 before the second product, and
    # the second product's output stays f32 (no bf16 rounding of x).
    E = torch.tensor([[1.0, 2.0**-8 + 2.0**-10]], dtype=torch.bfloat16)
    Dt = torch.tensor([[1.0], [3.0]], dtype=torch.bfloat16)
    b = torch.tensor([1.0, 1.0], dtype=torch.bfloat16)
    x = gemv_pair(b, E, Dt)
    ref = _jax_pair(np.ones(2, np.float32), jnp.asarray(E.float().numpy().T, jnp.bfloat16),
                    jnp.asarray(Dt.float().numpy().T, jnp.bfloat16), jnp.bfloat16, 1)
    assert x.tolist() == ref.tolist() == [1.0 + 2.0**-7, 3.0 * (1.0 + 2.0**-7)]


@pytest.mark.parametrize("K", [1, 3])
@pytest.mark.parametrize("m,n", [(7, 33), (48, 160)])
def test_gemv_pair_takes_an_f32_b_with_bf16_streams(K, m, n):
    # An f32 b is rounded to bf16 where the pair reads it: the same bits
    # as handing over b.to(torch.bfloat16).
    b, E, Dt = gemv_pair_probe.make_operands(m, n, torch.device("cpu"), torch.bfloat16)
    b32 = torch.from_numpy(np.random.default_rng(m).standard_normal(n).astype(np.float32))
    x = gemv_pair(b32, E, Dt, K)
    assert torch.equal(x, gemv_pair(b32.to(torch.bfloat16), E, Dt, K))
    assert not torch.equal(b32, b32.to(torch.bfloat16).float())  # b32 does round
    with pytest.raises(TypeError, match="float32"):
        gemv_pair(b32.double(), E, Dt, K)


def test_bf16_fat_shift_solver_hands_k2_an_f32_b():
    rng = np.random.default_rng(12)
    D = torch.from_numpy((rng.standard_normal((24, 80)) / 5).astype(np.float32))
    fat = FatShiftSolver.from_matrix(D, 1.0, torch.bfloat16)
    b = torch.from_numpy(rng.standard_normal(80).astype(np.float32))
    rho0 = fat.rho0
    pre = gemv_pair(b.to(torch.bfloat16), fat.E, fat.Dt)
    assert torch.equal(fat.solve(b), b / rho0 - pre / (rho0 * rho0))


@pytest.mark.parametrize("ddtype", [np.float32, np.float64])
def test_bf16_fat_shift_solver_matches_jax(ddtype):
    rng = np.random.default_rng(11)
    m, n = 48, 160
    D = (rng.standard_normal((m, n)) / 7).astype(ddtype)
    s = rng.standard_normal(m).astype(ddtype)
    _, _, _, jdata = jax_make_prox_ops(jnp.asarray(D), jnp.asarray(s), 0.1, JaxConfig(),
                                       stream_dtype=jnp.bfloat16)
    data, _ = lasso_data(numpy_state(jdata))
    fat = data["fat"]
    assert fat.D.dtype == fat.E.dtype == torch.bfloat16
    assert data["D"].dtype == fat.rho0.dtype == torch.from_numpy(D).dtype
    b = rng.standard_normal(n).astype(ddtype)
    x = fat.solve(torch.from_numpy(b))
    ref = np.asarray(jdata["fat"].solve(jnp.asarray(b)))
    assert x.dtype == torch.from_numpy(b).dtype
    # The same bf16 operands carried bit for bit and the same rounding
    # points (b once to bf16, even from f64; E b to bf16; f32 sums);
    # only the f32 summation order differs.
    assert np.linalg.norm(x.numpy() - ref) <= 1e-4 * np.linalg.norm(ref)


@pytest.mark.parametrize("rho", [1.0, 1.3])
def test_resident_lasso_plain_version_matches_jax_engine_f64(rho):
    rng = np.random.default_rng(3)
    m, n, K = 40, 120, 24
    D = rng.standard_normal((m, n))
    D = D / np.sqrt(np.sum(D**2, axis=0, keepdims=True))
    s = D @ (rng.standard_normal(n) * (rng.random(n) < 0.3)) + 0.03 * rng.standard_normal(m)
    lam = 0.1 * np.max(np.abs(D.T @ s))
    cfg = dict(maxiters=K, domaxiters=True, rho=rho, unroll=4)
    jres = jax_lasso(D, s, lam, JaxConfig(**cfg), use_fused_kernel=True)
    # The prototype's operands from admm_tpu's own setup (E, D^T s).
    _, _, _, jdata = jax_make_prox_ops(jnp.asarray(D), jnp.asarray(s), lam, JaxConfig(**cfg))
    data, _ = lasso_data(numpy_state(jdata))
    z, u = torch.zeros(n, dtype=torch.float64), torch.zeros(n, dtype=torch.float64)
    hist = resident_lasso(z, u, data["Dts"], data["fat"].E, data["fat"].D.T, rho,
                          lam / rho, K)
    assert resident_lasso.launches == 0  # the CPU runs the plain version
    # K3's fused form u' = (u + x) - z' is the engine's fused_zu; f64 with
    # the same E, so only the summation order of the norms can differ.
    np.testing.assert_allclose(z.numpy(), np.asarray(jres.zopt), rtol=1e-9, atol=1e-12)
    np.testing.assert_allclose(u.numpy(), np.asarray(jres.uopt), rtol=1e-9, atol=1e-12)
    np.testing.assert_allclose(hist[:, 0].numpy(), np.asarray(jres.pnorm) ** 2, rtol=1e-9)
    np.testing.assert_allclose(hist[:, 1].numpy(), np.asarray(jres.dnorm) ** 2, rtol=1e-9)


def test_gemv_pair_probe_smoke_on_cpu(capsys, monkeypatch):
    monkeypatch.setattr(gemv_pair, "launches", 0)
    rows = gemv_pair_probe.main(["--smoke", "--device", "cpu"])
    assert [r["name"] for r in rows] == ["gemv pair f32", "gemv pair bf16"]
    assert all(r["finite"] and r["us_per_iter"] > 0 for r in rows)
    out = capsys.readouterr().out
    assert "m=48 n=160" in out and out.count("us/iter") == 2
    assert gemv_pair.launches == 0


def test_resident_iter_proto_smoke_on_cpu(capsys):
    r = resident_iter_proto.main(["--smoke", "--device", "cpu"])
    # f32 against NumPy f64 over 64 steps (prototype's own check).
    assert r["z_err"] < 1e-5 and r["u_err"] < 1e-5
    assert "z err vs numpy" in capsys.readouterr().out
    # The history is the port engine's: same problem, fused z/u step.
    D, s, lam = resident_iter_proto.make_problem(smoke=True)
    res = lasso(D, s, lam, ADMMConfig(maxiters=64, domaxiters=True, unroll=64),
                use_fused_kernel=True, device="cpu")
    p2 = np.asarray(res.pnorm, np.float64) ** 2
    # Two f32 runs of the step differ by about eps_f32 ||x|| in x (another
    # summation order), so pnorm^2 agrees to 1e-3 only while pnorm is well
    # above that: 1e-7 of its first value.
    big = p2 >= 1e-7 * p2[0]
    np.testing.assert_allclose(r["hist"][big, 0].numpy(), p2[big], rtol=1e-3)
    assert big.sum() >= 30


# ---- K2's derivative rules (ops/gemv_pair.StreamPair) --------------------


def _bf16_fat_pair(ddtype, seed=21, m=40, n=120):
    """admm_tpu's bf16 FatShiftSolver and the port's, carried across bit for
    bit (convert.lasso_data), with a b and two random directions."""
    rng = np.random.default_rng(seed)
    D = (rng.standard_normal((m, n)) / 6).astype(ddtype)
    s = rng.standard_normal(m).astype(ddtype)
    _, _, _, jdata = jax_make_prox_ops(jnp.asarray(D), jnp.asarray(s), 0.1, JaxConfig(),
                                       stream_dtype=jnp.bfloat16)
    data, _ = lasso_data(numpy_state(jdata))
    b, g, h = (rng.standard_normal(n).astype(ddtype) for _ in range(3))
    return jdata["fat"], data["fat"], b, g, h


def _rel(a, ref):
    a, ref = np.asarray(a, np.float64), np.asarray(ref, np.float64)
    return np.max(np.abs(a - ref)) / np.max(np.abs(ref))


# K2's rules round where JAX's transpose of FatShiftSolver.solve rounds:
# the cotangent D g is rounded to bf16 between the products, g itself is
# not, and E^T (D g) is rounded to bf16; the tangent is the forward pair on
# b'.  The same rounding points leave the f32 sums' order: measured <= 6e-8
# relative here.  Bar 1e-6, well inside the forward's 2e-2 (bf16 against f32).
RULE_BAR = 1e-6


@pytest.mark.parametrize("ddtype", [np.float32, np.float64])
def test_k2_backward_and_tangent_match_jax(ddtype):
    import jax

    jfat, fat, b, g, h = _bf16_fat_pair(ddtype)
    tb, tg, th = (torch.from_numpy(v) for v in (b, g, h))
    _, jpull = jax.vjp(jfat.solve, jnp.asarray(b))
    _, pull = torch.func.vjp(fat.solve, tb)
    assert _rel(pull(tg)[0].numpy(), jpull(jnp.asarray(g))[0]) <= RULE_BAR
    _, jt = jax.jvp(jfat.solve, (jnp.asarray(b),), (jnp.asarray(g),))
    _, tt = torch.func.jvp(fat.solve, (tb,), (tg,))
    assert _rel(tt.numpy(), jt) <= RULE_BAR
    # The backward is itself differentiable (diff.py's mode='jvp' takes the
    # VJP of a VJP): its transpose is the forward pair again.
    _, jpp = jax.vjp(lambda v: jpull(v)[0], jnp.asarray(g))
    _, pp = torch.func.vjp(lambda v: pull(v)[0], tg)
    assert _rel(pp(th)[0].numpy(), jpp(jnp.asarray(h))[0]) <= RULE_BAR


def test_k2_rules_route_autograd_torch_func_and_lanes():
    from admm_tpu_torch.ops.gemv_pair import _gemv_pair_torch

    _, fat, b, g, _ = _bf16_fat_pair(np.float32)
    tb, tg = torch.from_numpy(b), torch.from_numpy(g)
    # torch.autograd and torch.func take the same rule.
    bb = tb.clone().requires_grad_()
    (ga,) = torch.autograd.grad(fat.solve(bb), bb, tg)
    assert torch.equal(ga, torch.func.vjp(fat.solve, tb)[1](tg)[0])
    # Its K-step form: the transposed chain, against autograd of the plain
    # version's own graph (whose .to(bf16) casts round the cotangents too).
    E, Dt = fat.E, fat.Dt
    for K in (1, 3):
        bb = tb.clone().requires_grad_()
        (gk,) = torch.autograd.grad(gemv_pair(bb, E, Dt, K), bb, tg)
        bb = tb.clone().requires_grad_()
        (gp,) = torch.autograd.grad(_gemv_pair_torch(bb, E, Dt, K), bb, tg)
        assert _rel(gk.numpy(), gp.numpy()) <= RULE_BAR
        _, tk = torch.func.jvp(lambda v: gemv_pair(v, E, Dt, K), (tb,), (tg,))
        assert torch.equal(tk, gemv_pair(tg, E, Dt, K))
    # Lanes (vmap) keep the plain version; jacrev vmaps the backward.
    B = torch.from_numpy(np.random.default_rng(3).standard_normal((3, b.size)).astype(np.float32))
    lanes = torch.func.vmap(fat.solve)(B)
    assert _rel(lanes.numpy(), torch.stack([fat.solve(r) for r in B]).numpy()) <= RULE_BAR
    J = torch.func.jacrev(fat.solve)(tb)
    assert J.shape == (b.size, b.size)
    e5 = torch.zeros_like(tb)
    e5[5] = 1.0  # the rounded backward is not linear: compare one row, not J^T g
    assert _rel(J[5].numpy(), torch.func.vjp(fat.solve, tb)[1](e5)[0].numpy()) <= RULE_BAR
    # The transposed operands are built once, at the first backward.
    assert fat.pair.transposed() is fat.pair.transposed()
    assert fat.pair.transposed().transposed() is fat.pair
    assert fat.pair.transposed().E.data_ptr() == fat.D.data_ptr()
