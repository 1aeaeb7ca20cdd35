"""Implicit differentiation of the port (``admm_tpu_torch/diff.py``) against
admm_tpu's (``admm_tpu/diff.py``): every serial, batch and covsel case of
tests/test_diff.py with its bars (finite differences rtol 2e-4, the
closed-form quadratic 1e-6, GMRES against Neumann 1e-5, jacfwd against
jacrev 1e-5, the one-step map against the engine 1e-12), and beside each
the port's gradient against admm_tpu's on the same numpy data: rtol 1e-8
for Neumann, 1e-6 for GMRES (both stop at vjp_tol, not iterate by
iterate).  The jit cases of tests/test_diff.py have no counterpart.  f64.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from admm_tpu.config import ADMMConfig as JConfig
from admm_tpu.diff import make_implicit_batch_solver as jax_batch_solver
from admm_tpu.diff import make_implicit_solver as jax_solver
from admm_tpu_torch import ADMMConfig, admm, make_implicit_batch_solver, make_implicit_solver
from admm_tpu_torch import diff

torch.set_num_threads(1)
T64 = torch.float64


# ---- the proxes of tests/test_diff.py, in torch and in JAX ------------------

def lasso_prox_f(xhat, z, u, rho, data):
    A, b = data["A"], data["b"]
    G = A.T @ A + rho * torch.eye(A.shape[1], dtype=A.dtype)
    return torch.linalg.solve(G, A.T @ b + rho * (z - u))


def lasso_prox_g(xhat, z, u, rho, data):
    v = xhat + u
    return torch.sign(v) * torch.clamp_min(torch.abs(v) - data["lam"] / rho, 0.0)


def quad_prox_g(xhat, z, u, rho, data):
    return rho / (data["gam"] + rho) * (xhat + u)


def j_lasso_prox_f(xhat, z, u, rho, data):
    A, b = data["A"], data["b"]
    G = A.T @ A + rho * jnp.eye(A.shape[1], dtype=A.dtype)
    return jnp.linalg.solve(G, A.T @ b + rho * (z - u))


def j_lasso_prox_g(xhat, z, u, rho, data):
    v = xhat + u
    return jnp.sign(v) * jnp.maximum(jnp.abs(v) - data["lam"] / rho, 0.0)


def j_quad_prox_g(xhat, z, u, rho, data):
    return rho / (data["gam"] + rho) * (xhat + u)


def _lasso_np(rng, m=12, n=8, lam=0.35):
    A = rng.standard_normal((m, n))
    xtrue = rng.standard_normal(n) * (rng.random(n) < 0.5)
    b = A @ xtrue + 0.01 * rng.standard_normal(m)
    return {"A": A, "b": b, "lam": np.float64(lam)}


def _t(d):
    return {k: torch.as_tensor(np.asarray(v), dtype=T64) for k, v in d.items()}


def _j(d):
    return {k: jnp.asarray(v) for k, v in d.items()}


_KW = dict(rho=1.0, maxiters=4000, abstol=1e-12, reltol=1e-12, quiet=True)
_CFG, _JCFG = ADMMConfig(**_KW), JConfig(**_KW)
_SHAPE = dict(nA=8, nB=8, m=8)


def _fd(f, x, h=1e-6):
    return (f(x + h) - f(x - h)) / (2 * h)


def _pair(kind="lasso", **kw):
    """(port solver, admm_tpu solver) on the lasso or quadratic proxes."""
    cfg, jcfg = kw.pop("cfg", (_CFG, _JCFG))
    pg, jpg = (lasso_prox_g, j_lasso_prox_g) if kind == "lasso" else (quad_prox_g, j_quad_prox_g)
    shape = kw.pop("shape", _SHAPE)
    return (make_implicit_solver(lasso_prox_f, pg, cfg, device="cpu", **shape, **kw),
            jax_solver(j_lasso_prox_f, jpg, jcfg, **shape, **kw))


def _close(a, b, rtol, atol=0.0):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=rtol, atol=atol)


# ---- TestImplicitGradients ---------------------------------------------------

def test_lasso_lambda_gradient_matches_fd_and_admm_tpu(rng):
    d = _lasso_np(rng)
    solve, jsolve = _pair()
    data, jdata = _t(d), _j(d)

    def loss_at(lam):
        return torch.sum(solve(dict(data, lam=torch.as_tensor(lam, dtype=T64)))[0] ** 2)

    g = torch.func.grad(loss_at)(data["lam"])
    assert torch.isfinite(g)
    _close(g, _fd(loss_at, float(d["lam"])), 2e-4, 1e-8)
    jg = jax.grad(lambda lam: jnp.sum(jsolve(dict(jdata, lam=lam))[0] ** 2))(jdata["lam"])
    _close(g, jg, 1e-8)


def test_lasso_b_gradient_matches_fd_and_admm_tpu(rng):
    d = _lasso_np(rng)
    solve, jsolve = _pair()
    data = _t(d)

    def loss(dd):
        return torch.sum(torch.cos(solve(dd)[0]))

    g = torch.func.grad(loss)(data)["b"]
    for i in [0, 3, 11]:
        def f(bi, i=i):
            b = data["b"].clone()
            b[i] = bi
            return loss(dict(data, b=b))
        _close(g[i], _fd(f, float(d["b"][i])), 2e-4, 1e-8)
    jg = jax.grad(lambda dd: jnp.sum(jnp.cos(jsolve(dd)[0])))(_j(d))["b"]
    _close(g, jg, 1e-8)


def test_quadratic_matches_closed_form(rng):
    m, n = 10, 6
    A, b = rng.standard_normal((m, n)), rng.standard_normal(m)
    d = {"A": A, "b": b, "gam": np.float64(0.7)}
    solve, jsolve = _pair("quad", shape=dict(nA=n, nB=n, m=n))
    got = torch.func.grad(lambda dd: torch.sum(solve(dd)[0]))(_t(d))["b"]
    expect = A @ np.linalg.solve(A.T @ A + 0.7 * np.eye(n), np.ones(n))
    _close(got, expect, 1e-6, 1e-9)
    jg = jax.grad(lambda dd: jnp.sum(jsolve(dd)[0]))(_j(d))["b"]
    _close(got, jg, 1e-8)


def test_gmres_agrees_with_neumann_and_admm_tpu(rng):
    d = _lasso_np(rng)
    s_ne, _ = _pair(vjp_method="neumann")
    s_gm, j_gm = _pair(vjp_method="gmres")

    def grad(solve):
        return torch.func.grad(lambda dd: torch.sum(solve(dd)[0] * solve(dd)[1]))(_t(d))

    g1, g2 = grad(s_ne), grad(s_gm)
    _close(g1["lam"], g2["lam"], 1e-5)
    _close(g1["b"], g2["b"], 1e-5, 1e-10)
    jg = jax.grad(lambda dd: jnp.sum(j_gm(dd)[0] * j_gm(dd)[1]))(_j(d))
    _close(g2["lam"], jg["lam"], 1e-6)
    _close(g2["b"], jg["b"], 1e-6, 1e-10)


def test_relaxed_iteration_gradient(rng):
    d = _lasso_np(rng)
    kw = dict(_KW, relax=1.5)
    solve, jsolve = _pair(cfg=(ADMMConfig(**kw), JConfig(**kw)))
    data = _t(d)

    def loss_at(lam):
        return torch.sum(solve(dict(data, lam=torch.as_tensor(lam, dtype=T64)))[0] ** 2)

    g = torch.func.grad(loss_at)(data["lam"])
    _close(g, _fd(loss_at, float(d["lam"])), 2e-4, 1e-8)
    jg = jax.grad(lambda lam: jnp.sum(jsolve(dict(_j(d), lam=lam))[0] ** 2))(jnp.asarray(d["lam"]))
    _close(g, jg, 1e-8)


def test_backward_api_equals_torch_func_grad(rng):
    # loss.backward() on a leaf that requires grad reaches the same rule.
    d = _lasso_np(rng)
    solve, _ = _pair()
    data = _t(d)
    lam = data["lam"].clone().requires_grad_()
    torch.sum(solve(dict(data, lam=lam))[0] ** 2).backward()
    g = torch.func.grad(lambda l: torch.sum(solve(dict(data, lam=l))[0] ** 2))(data["lam"])
    assert torch.equal(lam.grad, g)


# ---- TestComposition ---------------------------------------------------------

def test_lambda_lanes_through_the_batch_solver(rng):
    # tests/test_diff.py's vmap over lambda: the batch solver's lanes, and
    # torch.func.vmap over the serial solve, which runs the same lanes.
    d = _lasso_np(rng)
    data = _t(d)
    solve, jsolve = _pair()
    batch = make_implicit_batch_solver(lasso_prox_f, lasso_prox_g, _CFG, mapped={"lam"},
                                       device="cpu", **_SHAPE)
    lams = torch.tensor([0.1, 0.35, 0.8], dtype=T64)

    def serial_loss(lam):
        return torch.sum(solve(dict(data, lam=lam))[0] ** 2)

    vals = torch.sum(batch(dict(data, lam=lams))[0] ** 2, dim=1)
    grads = torch.func.grad(lambda l: torch.sum(batch(dict(data, lam=l))[0] ** 2))(lams)
    for i in range(3):
        _close(vals[i], serial_loss(lams[i]), 1e-10)
        _close(grads[i], torch.func.grad(serial_loss)(lams[i]), 1e-8)
    jloss = lambda l: jnp.sum(jsolve(dict(_j(d), lam=l))[0] ** 2)  # noqa: E731
    _close(grads, jax.vmap(jax.grad(jloss))(jnp.asarray(lams.numpy())), 1e-8)
    vvals = torch.func.vmap(serial_loss)(lams)
    assert torch.equal(vvals, vals)


def test_vmap_and_vmap_of_grad_over_the_serial_solver(rng):
    # tests/test_diff.py::TestComposition::test_jit_and_vmap_over_lambda:
    # vmap(loss) and vmap(grad(loss)) over the serial solve, each lane
    # against the serial value (1e-10) and gradient (1e-8), and against
    # jax.vmap of admm_tpu's.  The forward is one lanes runner, the
    # backward one lanes adjoint (each lane frozen at its own stop).
    d = _lasso_np(rng)
    data = _t(d)
    solve, jsolve = _pair()

    def loss_at(lam):
        return torch.sum(solve(dict(data, lam=lam))[0] ** 2)

    lams = torch.tensor([0.1, 0.35, 0.8], dtype=T64)
    vals = torch.func.vmap(loss_at)(lams)
    grads = torch.func.vmap(torch.func.grad(loss_at))(lams)
    steps = list(solve.stats["steps"])
    assert len(steps) == 3
    for i in range(3):
        _close(vals[i], loss_at(lams[i]), 1e-10)
        _close(grads[i], torch.func.grad(loss_at)(lams[i]), 1e-8)
        assert solve.stats["steps"] == [steps[i]]
    jloss = lambda l: jnp.sum(jsolve(dict(_j(d), lam=l))[0] ** 2)  # noqa: E731
    jl = jnp.asarray(lams.numpy())
    _close(vals, jax.vmap(jloss)(jl), 1e-10)
    _close(grads, jax.vmap(jax.grad(jloss))(jl), 1e-8)


def test_vmap_over_data_and_iterates_of_the_serial_solver(rng):
    # A batched b (a data leaf of more than one dimension) and a batched
    # start x0, the lanes sharing A: every lane equals its serial solve.
    d = _lasso_np(rng)
    data = _t(d)
    solve, _ = _pair()
    bs = torch.from_numpy(rng.standard_normal((2, 12)))
    x0s = torch.from_numpy(rng.standard_normal((2, 8)))
    X, Z, U = torch.func.vmap(lambda b, x0: solve(dict(data, b=b), x0=x0))(bs, x0s)
    gb = torch.func.vmap(torch.func.grad(
        lambda b: torch.sum(solve(dict(data, b=b))[0] ** 2)))(bs)
    for i in range(2):
        x, z, u = solve(dict(data, b=bs[i]), x0=x0s[i])
        _close(X[i], x, 1e-10, 1e-14)
        _close(Z[i], z, 1e-10, 1e-14)
        _close(U[i], u, 1e-10, 1e-14)
        g = torch.func.grad(lambda b: torch.sum(solve(dict(data, b=b))[0] ** 2))(bs[i])
        _close(gb[i], g, 1e-8, 1e-12)


def test_jacrev_over_the_batch_solver_matches_jax(rng):
    # jacrev over make_implicit_batch_solver's solve: torch.func.vmap over
    # its backward folds the cotangent batch into the lanes (outer batch
    # major), against jax.jacrev of admm_tpu's batch solver.
    d = _lasso_np(rng)
    data = _t(d)
    batch = make_implicit_batch_solver(lasso_prox_f, lasso_prox_g, _CFG, mapped={"lam"},
                                       device="cpu", **_SHAPE)
    jbatch = jax_batch_solver(j_lasso_prox_f, j_lasso_prox_g, _JCFG, mapped={"lam"}, **_SHAPE)
    lams = np.array([0.1, 0.35, 0.8])
    J = torch.func.jacrev(lambda l: batch(dict(data, lam=l))[0])(torch.from_numpy(lams))
    jJ = jax.jacrev(lambda l: jbatch(dict(_j(d), lam=l))[0])(jnp.asarray(lams))
    assert J.shape == (3, 8, 3)
    _close(J, jJ, 1e-8, 1e-12)
    # Lanes do not couple: the off-diagonal blocks are exact zeros.
    for i in range(3):
        for k in range(3):
            if i != k:
                assert not J[i, :, k].any()


def test_vmap_of_jvp_and_jacfwd_over_the_lanes(rng):
    # Forward mode under vmap: vmap(jvp) over the serial solve equals the
    # serial tangents (1e-10), and jacfwd over the batch solver (its
    # tangents folded into the lanes) equals jacrev (rtol 1e-5, as
    # test_jacfwd_matches_jacrev; atol 1e-8 of entries that are zero up to
    # the linear solves' 1e-9 tolerance).
    d = _lasso_np(rng)
    data = _t(d)
    solve, _ = _pair(mode="jvp")

    def loss(lam):
        return torch.sum(solve(dict(data, lam=lam))[0] ** 2)

    lams = torch.tensor([0.1, 0.35, 0.8], dtype=T64)
    tan = torch.func.vmap(lambda l: torch.func.jvp(loss, (l,), (torch.ones_like(l),))[1])(lams)
    for i in range(3):
        _close(tan[i], torch.func.jvp(loss, (lams[i],), (torch.ones_like(lams[i]),))[1], 1e-10)
    kw = dict(mapped={"lam"}, device="cpu", **_SHAPE)
    fwd = make_implicit_batch_solver(lasso_prox_f, lasso_prox_g, _CFG, mode="jvp", **kw)
    rev = make_implicit_batch_solver(lasso_prox_f, lasso_prox_g, _CFG, **kw)
    Jf = torch.func.jacfwd(lambda l: fwd(dict(data, lam=l))[0])(lams)
    Jr = torch.func.jacrev(lambda l: rev(dict(data, lam=l))[0])(lams)
    _close(Jf, Jr, 1e-5, 1e-8)


def test_no_gradient_to_initial_iterates(rng):
    d = _lasso_np(rng)
    solve, _ = _pair()
    x0 = torch.from_numpy(rng.standard_normal(8))
    g = torch.func.grad(lambda x: torch.sum(solve(_t(d), x0=x)[0] ** 2))(x0)
    assert torch.equal(g, torch.zeros_like(x0))


def test_forward_matches_engine(rng):
    d = _lasso_np(rng)
    solve, jsolve = _pair()
    data = _t(d)
    x, z, u = solve(data)
    res = admm(lasso_prox_f, lasso_prox_g, _CFG, m=8, data=data, dtype=T64, device="cpu")
    assert torch.equal(x, res.xopt) and torch.equal(z, res.zopt) and torch.equal(u, res.uopt)
    jx = jsolve(_j(d))[0]
    _close(x, jx, 1e-10, 1e-14)


# ---- TestForwardMode ---------------------------------------------------------

def test_jvp_lambda_matches_fd_and_admm_tpu(rng):
    d = _lasso_np(rng)
    solve, jsolve = _pair(mode="jvp")
    data = _t(d)

    def loss_at(lam):
        return torch.sum(solve(dict(data, lam=torch.as_tensor(lam, dtype=T64)))[0] ** 2)

    lam0 = data["lam"]
    _, dot = torch.func.jvp(loss_at, (lam0,), (torch.ones_like(lam0),))
    _close(dot, _fd(loss_at, float(lam0)), 2e-4, 1e-8)
    jl = lambda l: jnp.sum(jsolve(dict(_j(d), lam=l))[0] ** 2)  # noqa: E731
    _, jdot = jax.jvp(jl, (jnp.asarray(d["lam"]),), (jnp.ones(()),))
    _close(dot, jdot, 1e-8)


def test_jacfwd_matches_jacrev(rng):
    d = _lasso_np(rng)
    data = _t(d)
    s_f, j_f = _pair(mode="jvp")
    s_r, _ = _pair(mode="vjp")
    Jf = torch.func.jacfwd(lambda b: s_f(dict(data, b=b))[0])(data["b"])
    Jr = torch.func.jacrev(lambda b: s_r(dict(data, b=b))[0])(data["b"])
    _close(Jf, Jr, 1e-5, 1e-9)
    jJ = jax.jacfwd(lambda b: j_f(dict(_j(d), b=b))[0])(jnp.asarray(d["b"]))
    _close(Jf, jJ, 1e-8, 1e-12)


def test_forward_ad_api_equals_torch_func_jvp(rng):
    # torch.autograd.forward_ad reaches the same tangent rule.
    import torch.autograd.forward_ad as fwAD

    d = _lasso_np(rng)
    solve, _ = _pair(mode="jvp")
    data = _t(d)
    with fwAD.dual_level():
        lam = fwAD.make_dual(data["lam"], torch.ones((), dtype=T64))
        tangent = fwAD.unpack_dual(solve(dict(data, lam=lam))[0]).tangent
    _, ref = torch.func.jvp(lambda l: solve(dict(data, lam=l))[0], (data["lam"],),
                            (torch.ones((), dtype=T64),))
    assert torch.equal(tangent, ref)


def test_quadratic_jacfwd_matches_closed_form(rng):
    m, n = 10, 6
    A, b = rng.standard_normal((m, n)), rng.standard_normal(m)
    d = {"A": A, "b": b, "gam": np.float64(0.7)}
    solve, jsolve = _pair("quad", shape=dict(nA=n, nB=n, m=n), mode="jvp")
    data = _t(d)
    J = torch.func.jacfwd(lambda b_: solve(dict(data, b=b_))[0])(data["b"])
    _close(J, np.linalg.solve(A.T @ A + 0.7 * np.eye(n), A.T), 1e-6, 1e-9)
    jJ = jax.jacfwd(lambda b_: jsolve(dict(_j(d), b=b_))[0])(jnp.asarray(b))
    _close(J, jJ, 1e-8, 1e-12)


def test_jvp_gmres_agrees_with_neumann(rng):
    d = _lasso_np(rng)
    data = _t(d)
    s_ne, _ = _pair(mode="jvp", vjp_method="neumann")
    s_gm, j_gm = _pair(mode="jvp", vjp_method="gmres")
    tangent = {k: torch.ones_like(v) for k, v in data.items()}
    _, d1 = torch.func.jvp(lambda dd: s_ne(dd)[0], (data,), (tangent,))
    _, d2 = torch.func.jvp(lambda dd: s_gm(dd)[0], (data,), (tangent,))
    _close(d1, d2, 1e-5, 1e-8)
    jdata = _j(d)
    _, jd = jax.jvp(lambda dd: j_gm(dd)[0], (jdata,), (jax.tree_util.tree_map(jnp.ones_like, jdata),))
    _close(d2, jd, 1e-6, 1e-8)


@pytest.mark.parametrize("mode", ["vjp", "jvp"])
def test_solver_in_the_wrong_mode_names_the_mode(rng, mode):
    d = _lasso_np(rng)
    data = _t(d)
    solve, _ = _pair(mode=mode)
    lam0 = data["lam"]
    loss = lambda l: torch.sum(solve(dict(data, lam=l))[0] ** 2)  # noqa: E731
    other = "jvp" if mode == "vjp" else "vjp"
    with pytest.raises(RuntimeError, match=f"rebuild it with mode='{other}'"):
        if mode == "vjp":
            torch.func.jvp(loss, (lam0,), (torch.ones_like(lam0),))
        else:
            torch.func.grad(loss)(lam0)


# ---- TestFactoryValidation ---------------------------------------------------

def test_rejects_unknown_mode():
    with pytest.raises(ValueError, match="mode"):
        make_implicit_solver(lasso_prox_f, lasso_prox_g, ADMMConfig(), mode="both", **_SHAPE)


def test_rejects_momentum_and_dynamic_rho():
    with pytest.raises(ValueError, match="standard iteration"):
        make_implicit_solver(lasso_prox_f, lasso_prox_g, ADMMConfig(fast=True), **_SHAPE)
    with pytest.raises(ValueError, match="static rho"):
        make_implicit_solver(lasso_prox_f, lasso_prox_g, ADMMConfig(adaptive=True), **_SHAPE)
    with pytest.raises(ValueError, match="vjp_method"):
        make_implicit_solver(lasso_prox_f, lasso_prox_g, ADMMConfig(), vjp_method="cg", **_SHAPE)


def test_bwd_iteration_map_matches_engine_step(rng):
    # One engine iteration lands on the map the adjoint linearizes, relaxed
    # or not (the port's own map, _Factory.one_iter).
    d = _lasso_np(rng)
    data = _t(d)
    from admm_tpu_torch.linop import as_linop

    for relax in (1.0, 1.5):
        cfg = ADMMConfig(rho=1.0, relax=relax, maxiters=1, domaxiters=True)
        res = admm(lasso_prox_f, lasso_prox_g, cfg, m=8, data=data, dtype=T64, device="cpu")
        fac = diff._Factory(lasso_prox_f, lasso_prox_g, cfg, 1.0, -1.0, 8, 8, 8, None, None,
                            None, "vjp", "neumann", 500, 1e-9, "cpu")
        F = fac.one_iter(as_linop(1.0), as_linop(-1.0))
        zero = torch.zeros(8, dtype=T64)
        x1, z1, u1 = F((zero, zero, zero), zero, data)
        for got, ref in ((x1, res.xopt), (z1, res.zopt), (u1, res.uopt)):
            _close(got, ref, 1e-12)


def test_neumann_chunks_equal_a_step_by_step_loop(rng, monkeypatch):
    # K steps per host read with the finished solve frozen on the device:
    # the gradient is the one-step-per-read loop's, bit for bit, and one
    # backward reads ceil(steps / K) + 1 times.
    d = _lasso_np(rng)
    data = _t(d)
    solve, _ = _pair()
    loss = lambda l: torch.sum(solve(dict(data, lam=l))[0] ** 2)  # noqa: E731
    g8 = torch.func.grad(loss)(data["lam"])
    steps, reads = solve.stats["steps"][0], solve.stats["reads"]
    assert reads == -(-steps // diff.NEUMANN_CHUNK) + 1
    monkeypatch.setattr(diff, "NEUMANN_CHUNK", 1)
    g1 = torch.func.grad(loss)(data["lam"])
    assert torch.equal(g8, g1)
    assert solve.stats["steps"][0] == steps and solve.stats["reads"] == steps + 1


# ---- TestBackwardDivergenceDetection -------------------------------------------

def expansive_prox_f(xhat, z, u, rho, data):
    return data["a"] * (z - u) + data["b"]


def expansive_prox_g(xhat, z, u, rho, data):
    return xhat + u


def _expansive(mode="vjp", **kw):
    return make_implicit_solver(expansive_prox_f, expansive_prox_g, _CFG, nA=4, nB=4, m=4,
                                mode=mode, device="cpu", **kw)


def test_noncontractive_adjoint_poisons_gradients(capfd):
    solve = _expansive()
    g = torch.func.grad(lambda a: torch.sum(solve({"a": a, "b": torch.zeros(4, dtype=T64)})[0]))(
        torch.tensor(2.0, dtype=T64))
    assert torch.isnan(g)
    assert "admm_tpu_torch.diff: engine adjoint (VJP) linear solve DIVERGED" in capfd.readouterr().err


def test_noncontractive_tangent_poisons_jvp():
    solve = _expansive("jvp")
    b0 = torch.zeros(4, dtype=T64)
    _, dot = torch.func.jvp(lambda b: solve({"a": torch.tensor(2.0, dtype=T64), "b": b})[0],
                            (b0,), (torch.ones_like(b0),))
    assert torch.isnan(dot).all()


def test_contractive_solve_stays_finite():
    solve = _expansive()
    g = torch.func.grad(lambda a: torch.sum(solve({"a": a, "b": torch.zeros(4, dtype=T64)})[0] ** 2))(
        torch.tensor(0.5, dtype=T64))
    assert torch.isfinite(g)


def test_slow_contraction_is_warned_not_poisoned(rng, capfd):
    d = _lasso_np(rng)
    data = _t(d)
    solve, _ = _pair(vjp_maxiters=3, vjp_tol=1e-14)
    g = torch.func.grad(lambda l: torch.sum(solve(dict(data, lam=l))[0] ** 2))(data["lam"])
    assert torch.isfinite(g)
    assert "did not reach tolerance" in capfd.readouterr().err


def test_diverged_lanes_are_counted_per_lane(capfd):
    # One lane expansive, two contractive: only the expansive lane is NaN.
    batch = make_implicit_batch_solver(expansive_prox_f, expansive_prox_g, _CFG, mapped={"a"},
                                       nA=4, nB=4, m=4, device="cpu")
    a = torch.tensor([0.5, 2.0, 0.25], dtype=T64)
    g = torch.func.grad(lambda a_: torch.sum(batch({"a": a_, "b": torch.zeros(4, dtype=T64)})[0]))(a)
    assert torch.isfinite(g[0]) and torch.isnan(g[1]) and torch.isfinite(g[2])
    assert "DIVERGED (1/3 lanes)" in capfd.readouterr().err


# ---- TestImplicitBatch ---------------------------------------------------------

def _batch_setup(rng, B=3, m=12, n=8):
    from admm_tpu.models.lasso import make_prox_ops as jax_ops
    from admm_tpu_torch.models.lasso import make_prox_ops

    D, S = rng.standard_normal((m, n)), rng.standard_normal((B, m))
    lams = 0.2 + 0.3 * rng.random(B)
    pf, pg, _, data = make_prox_ops(torch.from_numpy(D), torch.from_numpy(S[0]), 1.0, _CFG)
    data = dict(data, s=torch.from_numpy(S), Dts=torch.from_numpy(S @ D),
                lam=torch.from_numpy(lams))
    jpf, jpg, _, jdata = jax_ops(jnp.asarray(D), jnp.asarray(S[0]), 1.0, _JCFG)
    jdata = dict(jdata, s=jnp.asarray(S), Dts=jnp.asarray(S @ D), lam=jnp.asarray(lams))
    return pf, pg, data, jpf, jpg, jdata, n


def test_per_lane_lambda_gradients_match_fd_and_admm_tpu(rng):
    pf, pg, data, jpf, jpg, jdata, n = _batch_setup(rng)
    mapped = {"s", "Dts", "lam"}
    solve = make_implicit_batch_solver(pf, pg, _CFG, mapped=mapped, nA=n, nB=n, m=n)

    def loss(lams):
        return torch.sum(solve(dict(data, lam=lams))[0] ** 2, dim=1)

    lams = data["lam"]
    g = torch.func.grad(lambda l: torch.sum(loss(l)))(lams)
    for i in range(len(lams)):
        def f(li, i=i):
            l2 = lams.clone()
            l2[i] = li
            return float(loss(l2)[i])
        _close(g[i], _fd(f, float(lams[i])), 2e-4, 1e-8)
    jsolve = jax_batch_solver(jpf, jpg, _JCFG, mapped=mapped, nA=n, nB=n, m=n)
    jg = jax.grad(lambda l: jnp.sum(jsolve(dict(jdata, lam=l))[0] ** 2))(jdata["lam"])
    _close(g, jg, 1e-8)


@pytest.mark.parametrize("method", ["neumann", "gmres"])
def test_batch_matches_serial_per_lane(rng, method):
    pf, pg, data, *_, n = _batch_setup(rng)
    mapped = {"s", "Dts", "lam"}
    batched = make_implicit_batch_solver(pf, pg, _CFG, mapped=mapped, nA=n, nB=n, m=n,
                                         vjp_method=method)
    serial = make_implicit_solver(pf, pg, _CFG, nA=n, nB=n, m=n, vjp_method=method)
    lams = data["lam"]
    gb = torch.func.grad(lambda l: torch.sum(batched(dict(data, lam=l))[0] ** 2))(lams)
    for i in range(len(lams)):
        lane = {k: (v[i] if k in mapped else v) for k, v in data.items()}
        gi = torch.func.grad(lambda li: torch.sum(serial(dict(lane, lam=li))[0] ** 2))(lams[i])
        _close(gb[i], gi, 1e-9, 1e-12)


def test_batch_jvp_mode_matches_vjp_mode(rng):
    pf, pg, data, *_, n = _batch_setup(rng)
    mapped = {"s", "Dts", "lam"}
    sv, sj = (make_implicit_batch_solver(pf, pg, _CFG, mapped=mapped, nA=n, nB=n, m=n, mode=m)
              for m in ("vjp", "jvp"))
    lams = data["lam"]
    g = torch.func.grad(lambda l: torch.sum(sv(dict(data, lam=l))[0] ** 2))(lams)
    # Lanes are independent: a ones tangent gives every lane's own derivative.
    _, dot = torch.func.jvp(lambda l: torch.sum(sj(dict(data, lam=l))[0] ** 2, dim=1), (lams,),
                            (torch.ones_like(lams),))
    _close(g, dot, 1e-7)


def test_matrix_iterates_covsel_hypergradient(rng):
    from admm_tpu.models.covarianceselection import _prox_f as j_cf, _prox_g as j_cg
    from admm_tpu_torch.models.covarianceselection import _prox_f, _prox_g

    n = 6
    Q = rng.standard_normal((n, 2 * n))
    S = Q @ Q.T / (2 * n) + 0.1 * np.eye(n)
    kw = dict(rho=1.0, maxiters=3000, abstol=1e-12, reltol=1e-12, quiet=True)
    solve = make_implicit_solver(_prox_f, _prox_g, ADMMConfig(**kw), shape_x=(n, n),
                                 shape_z=(n, n), device="cpu")
    St = torch.from_numpy(S)

    def loss_at(lam):
        return torch.sum(solve({"S": St, "lam": torch.as_tensor(lam, dtype=T64)})[0] ** 2)

    lam0 = torch.tensor(0.15, dtype=T64)
    g = torch.func.grad(loss_at)(lam0)
    _close(g, _fd(loss_at, 0.15, h=1e-5), 5e-4, 1e-8)
    jsolve = jax_solver(j_cf, j_cg, JConfig(**kw), shape_x=(n, n), shape_z=(n, n), m=None)
    jg = jax.grad(lambda lam: jnp.sum(jsolve({"S": jnp.asarray(S), "lam": lam})[0] ** 2))(
        jnp.asarray(0.15))
    _close(g, jg, 1e-8)


# ---- the kernels' autograd guard (ops/_cuda.refuse_autograd) -----------------

def _meta(*shape, grad=False):
    return torch.zeros(shape, device="meta", requires_grad=grad)


@pytest.mark.parametrize("name", ["fused_soft_threshold_dual", "fused_zu_tail", "gemv_pair",
                                  "resident_lasso", "fused_diff_tail"])
@pytest.mark.parametrize("how", ["requires_grad", "torch.func.grad", "forward_ad"])
def test_ctypes_wrappers_refuse_autograd_before_launching(monkeypatch, name, how):
    # Off the CPU a ctypes launch would come back without a grad_fn; each
    # wrapper without derivative rules refuses autograd and torch.func first.  Meta tensors pass
    # every shape and dtype check and reach the guard, so nothing launches.
    import torch.autograd.forward_ad as fwAD

    from admm_tpu_torch.ops import _cuda, gemv_pair as gp, kernels

    monkeypatch.setattr(_cuda, "library", lambda: pytest.fail("the kernel library was loaded"))
    n, m = 8, 4
    calls = {
        "fused_soft_threshold_dual": lambda x: kernels.fused_soft_threshold_dual(
            x, _meta(n), _meta()),
        "fused_zu_tail": lambda x: kernels.fused_zu_tail(
            x, _meta(n), _meta(n), _meta(n), _meta(), _meta(), torch.zeros(3, dtype=torch.int64,
                                                                           device="meta"),
            _meta(4, 11), perr_abs=0.0, derr_abs=0.0, reltol=0.0),
        "fused_diff_tail": lambda x: kernels.fused_diff_tail(
            x, _meta(n), _meta(n), _meta(n), _meta(), _meta(), torch.zeros(3, dtype=torch.int64,
                                                                           device="meta"),
            _meta(4, 11), perr_abs=0.0, derr_abs=0.0, reltol=0.0),
        "gemv_pair": lambda x: gp.gemv_pair(x, _meta(m, n), _meta(n, m)),
        "resident_lasso": lambda x: gp.resident_lasso(x, _meta(n), _meta(n), _meta(m, n),
                                                      _meta(n, m), 1.0, 0.1, 1),
    }
    call = calls[name]
    # K2 has derivative rules (ops/gemv_pair.StreamPair): under autograd it
    # goes on to its launch, which refuses the meta device like the others.
    error, match = ((ValueError, "unsupported device meta") if name == "gemv_pair"
                    else (NotImplementedError, "no derivative rules"))
    with pytest.raises(error, match=match):
        if how == "requires_grad":
            call(_meta(n, grad=True))
        elif how == "torch.func.grad":
            torch.func.grad(lambda x: call(x) and x.sum())(_meta(n))
        else:
            with fwAD.dual_level():
                call(fwAD.make_dual(_meta(n), _meta(n)))
    # Without gradients the guard lets the call through to the device check.
    with pytest.raises(ValueError, match="unsupported device meta"):
        call(_meta(n))
