"""Implicit differentiation of the port's sharded runners
(``make_implicit_consensus_solver``, ``make_implicit_unwrapped_solver``)
against admm_tpu's: the twins of tests/test_diff.py's
TestImplicitConsensus and TestImplicitUnwrapped with their bars (finite
differences rtol 2e-4 to 3e-4, jvp against vjp 1e-6, the forward equal to
the sharded runner exactly), beside each the port's gradient against
admm_tpu's on the same numpy data (rtol 1e-8: both stop their Neumann
series at vjp_tol), on 8 stacked shards; and the same gradients over two
processes (one gloo group on the CPU, each rank its block of 4 shards)
against the stacked ones.  f64."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from admm_tpu.config import ADMMConfig as JConfig
from admm_tpu.diff import make_implicit_consensus_solver as j_consensus
from admm_tpu.diff import make_implicit_unwrapped_solver as j_unwrapped
from admm_tpu.parallel import consensus as JC
from admm_tpu_torch import ADMMConfig, make_implicit_consensus_solver, make_implicit_unwrapped_solver
from admm_tpu_torch.parallel import consensus as TC
from admm_tpu_torch.parallel import transpose_reduction as TTR
from admm_tpu_torch.parallel.mesh import make_mesh, pad_rows, shard_rows

from _torch_ranks import check, run_ranks

torch.set_num_threads(1)

W, N = 8, 10
_CFG = dict(rho=1.0, maxiters=4000, abstol=1e-12, reltol=1e-12, quiet=True)


def _fd(f, x, h=1e-6):
    return (f(x + h) - f(x - h)) / (2 * h)


def consensus_data(seed=0, m=64, n=N, lam=0.3):
    """The consensus LASSO's per-shard data (Minv, Dtsi, lam), made by each
    package's own setup from the same numpy D and s."""
    rng = np.random.default_rng(seed)
    D = rng.standard_normal((m, n))
    xtrue = rng.standard_normal(n) * (rng.random(n) < 0.5)
    s = D @ xtrue + 0.01 * rng.standard_normal(m)
    Di = shard_rows(pad_rows(D, W)[0], W)
    si = shard_rows(pad_rows(s, W)[0], W)
    data = TC.ls_setup(torch.as_tensor(Di), torch.as_tensor(si), False, 1.0)
    data = {"Minv": data["Minv"], "Dtsi": data["Dtsi"], "lam": torch.tensor(lam,
                                                                           dtype=torch.float64)}
    jdata = {k: jnp.asarray(v.numpy()) for k, v in data.items()}
    return D, s, data, jdata


def _solvers(global_prox="lasso", cfg=None, **kw):
    cfg = dict(_CFG, **(cfg or {}))
    tg = TC._lasso_global_prox if global_prox == "lasso" else TC._elasticnet_global_prox
    jg = JC._lasso_global_prox if global_prox == "lasso" else JC._elasticnet_global_prox
    return (make_implicit_consensus_solver(TC._lasso_local_prox, tg, ADMMConfig(**cfg), N, W,
                                           **kw),
            j_consensus(JC._lasso_local_prox, jg, JConfig(**cfg), N, W, **kw))


class TestImplicitConsensus:

    def test_forward_matches_consensus_lasso(self):
        D, s, data, _ = consensus_data()
        solve, _ = _solvers()
        xi, z, ui = solve(data)
        ref = TC.consensus_lasso(D, s, 0.3, ADMMConfig(**_CFG), mesh=make_mesh(W, device="cpu"))
        assert torch.equal(z, ref.zopt)
        assert torch.equal(torch.mean(xi, dim=0), ref.xopt)
        assert torch.equal(xi, ref.extra["xi"]) and torch.equal(ui, ref.extra["ui"])

    def test_lambda_gradient_matches_fd_and_admm_tpu(self):
        _, _, data, jdata = consensus_data()
        solve, jsolve = _solvers()

        def loss_at(lam):
            return torch.sum(solve(dict(data, lam=torch.as_tensor(lam, dtype=torch.float64)))[1] ** 2)

        g = torch.func.grad(loss_at)(data["lam"])
        assert torch.isfinite(g)
        np.testing.assert_allclose(float(g), _fd(lambda v: float(loss_at(v)), 0.3),
                                   rtol=2e-4, atol=1e-8)
        jg = jax.grad(lambda lam: jnp.sum(jsolve(dict(jdata, lam=lam))[1] ** 2))(jdata["lam"])
        np.testing.assert_allclose(float(g), float(jg), rtol=1e-8)

    def test_data_gradient_matches_fd(self):
        # The gradient in a per-shard leaf (Dtsi): the pullback through the
        # sharded local prox.
        _, _, data, jdata = consensus_data()
        solve, jsolve = _solvers()

        def loss(d):
            return torch.sum(torch.cos(solve(d)[1]))

        g = torch.func.grad(loss)(data)["Dtsi"]
        jg = jax.grad(lambda d: jnp.sum(jnp.cos(jsolve(d)[1])))(jdata)["Dtsi"]
        np.testing.assert_allclose(g.numpy(), np.asarray(jg), rtol=1e-8, atol=1e-12)
        for w_idx, j in [(0, 0), (3, 5), (7, 9)]:
            def f(v, w_idx=w_idx, j=j):
                Dtsi = data["Dtsi"].clone()
                Dtsi[w_idx, j] = v
                return float(loss(dict(data, Dtsi=Dtsi)))
            np.testing.assert_allclose(float(g[w_idx, j]), _fd(f, float(data["Dtsi"][w_idx, j])),
                                       rtol=3e-4, atol=1e-8)

    def test_relaxed_consensus_gradient(self):
        _, _, data, jdata = consensus_data()
        solve, jsolve = _solvers(cfg=dict(relax=1.3))

        def loss_at(lam):
            return torch.sum(solve(dict(data, lam=torch.as_tensor(lam, dtype=torch.float64)))[1] ** 2)

        g = torch.func.grad(loss_at)(data["lam"])
        np.testing.assert_allclose(float(g), _fd(lambda v: float(loss_at(v)), 0.3),
                                   rtol=2e-4, atol=1e-8)
        jg = jax.grad(lambda lam: jnp.sum(jsolve(dict(jdata, lam=lam))[1] ** 2))(jdata["lam"])
        np.testing.assert_allclose(float(g), float(jg), rtol=1e-8)

    def test_jvp_mode_matches_vjp(self):
        _, _, data, _ = consensus_data()
        s_v, _ = _solvers(mode="vjp")
        s_j, _ = _solvers(mode="jvp")
        lam0 = data["lam"]
        g = torch.func.grad(lambda lm: torch.sum(s_v(dict(data, lam=lm))[1] ** 2))(lam0)
        _, dot = torch.func.jvp(lambda lm: torch.sum(s_j(dict(data, lam=lm))[1] ** 2),
                                (lam0,), (torch.ones_like(lam0),))
        np.testing.assert_allclose(float(g), float(dot), rtol=1e-6)

    def test_accepts_unroll_auto(self):
        _, _, data, _ = consensus_data()
        solve, _ = _solvers(cfg=dict(maxiters=2000, abstol=1e-10, reltol=1e-10, unroll="auto"))
        xi, z, ui = solve(data)
        assert torch.isfinite(z).all()

    def test_generic_over_global_prox_elasticnet(self):
        _, _, data, jdata = consensus_data()
        data = dict(data, alpha=torch.tensor(0.6, dtype=torch.float64))
        jdata = dict(jdata, alpha=jnp.asarray(0.6))
        solve, jsolve = _solvers(global_prox="elasticnet")
        for key in ("lam", "alpha"):
            def loss_at(v, key=key):
                return torch.sum(solve(dict(data, **{key: torch.as_tensor(v, dtype=torch.float64)}))[1] ** 2)

            g = torch.func.grad(loss_at)(data[key])
            np.testing.assert_allclose(float(g), _fd(lambda v: float(loss_at(v)),
                                                     float(data[key])), rtol=3e-4, atol=1e-8)
            jg = jax.grad(lambda v, key=key: jnp.sum(jsolve(dict(jdata, **{key: v}))[1] ** 2))(
                jdata[key])
            np.testing.assert_allclose(float(g), float(jg), rtol=1e-8)

    def test_refuses_gmres_over_a_group_and_the_fast_iteration(self):
        with pytest.raises(ValueError, match="standard iteration"):
            _solvers(cfg=dict(fast=True))


def _wls_shard_prox(Dx, zi, ui, rho, aux):
    # Smooth per-shard prox: g_i(z) = gam/2 (z - s_i)^2.
    s_i, gam = aux
    return (rho * (Dx + ui) + gam * s_i) / (gam + rho)


def unwrapped_data(seed=0, m=64, n=6, C=1.0):
    rng = np.random.default_rng(seed)
    ell = np.sign(rng.standard_normal(m))
    D = rng.standard_normal((m, n))
    D[:, 0] += 2.0 * ell
    Di = torch.as_tensor(shard_rows(pad_rows(D, W)[0], W))
    mask = np.zeros(Di.shape[0] * Di.shape[1])
    mask[:m] = 1.0
    mask_i = torch.as_tensor(shard_rows(mask, W))
    ell_i = torch.as_tensor(shard_rows(pad_rows(ell, W)[0], W))
    data = {"Di": Di, "Winv": TTR.gram_pinv(Di), "mask": mask_i,
            "aux": (ell_i, mask_i, mask_i * C)}
    return D, ell, data, rng


def _jax_data(data):
    return jax.tree_util.tree_map(lambda t: jnp.asarray(t.numpy()), data)


class TestImplicitUnwrapped:

    def test_forward_matches_sharded_solver(self):
        D, ell, data, _ = unwrapped_data()
        cfg = ADMMConfig(**dict(_CFG, maxiters=3000, abstol=1e-11, reltol=1e-11,
                                nodualerror=True))
        solve = make_implicit_unwrapped_solver(TTR._svm_prox_hinge, cfg, 64, 6, W)
        x, zi, ui = solve(data)
        ref = TTR.unwrapped_admm_sharded(TTR._svm_prox_hinge, D, cfg,
                                         aux=(ell, np.ones(64), np.ones(64)), x0=np.zeros(6),
                                         z0=np.zeros(64), u0=np.zeros(64),
                                         mesh=make_mesh(W, device="cpu"))
        assert torch.equal(x, ref.xopt)
        assert torch.equal(zi, ref.zopt)

    def test_data_gradient_matches_fd_smooth_prox(self):
        _, _, data, rng = unwrapped_data()
        s_rows = torch.as_tensor(rng.standard_normal(tuple(data["mask"].shape))) * data["mask"]
        gam = torch.tensor(1.3, dtype=torch.float64)
        data = dict(data, aux=(s_rows, gam))
        cfg = dict(_CFG, nodualerror=True)
        solve = make_implicit_unwrapped_solver(_wls_shard_prox, ADMMConfig(**cfg), 64, 6, W)
        jsolve = j_unwrapped(_wls_shard_prox, JConfig(**cfg), 64, 6, W)

        def loss(d):
            return torch.sum(solve(d)[0] ** 2)

        g = torch.func.grad(loss)(data)
        jg = jax.grad(lambda d: jnp.sum(jsolve(d)[0] ** 2))(_jax_data(data))
        np.testing.assert_allclose(g["aux"][0].numpy(), np.asarray(jg["aux"][0]), rtol=1e-8,
                                   atol=1e-12)
        for idx in [(0, 0), (3, 5), (7, 7)]:
            def f(v, idx=idx):
                s2 = s_rows.clone()
                s2[idx] = v
                return float(loss(dict(data, aux=(s2, gam))))
            np.testing.assert_allclose(float(g["aux"][0][idx]), _fd(f, float(s_rows[idx])),
                                       rtol=3e-4, atol=1e-8)
        np.testing.assert_allclose(float(g["aux"][1]), 0.0, atol=1e-6)

    def test_refuses_mismatched_shards(self):
        _, _, data, _ = unwrapped_data()
        solve = make_implicit_unwrapped_solver(TTR._svm_prox_hinge, ADMMConfig(), 64, 6, 4)
        with pytest.raises(ValueError, match="must have shape"):
            solve(data)


def test_sharded_gradients_over_two_processes(tmp_path):
    """The lambda gradient of the consensus solver, the per-shard Dtsi
    gradient, and the smooth unwrapped solver's gradient over two ranks
    (each its block of 4 shards, the adjoint's means and sums all-reduced)
    equal the stacked gradients (1e-9; the per-shard ones 1e-8 of their
    largest entry); the whole lambda gradient and the adjoint's steps are
    the same on both ranks."""
    _, _, data, _ = consensus_data()
    solve, _ = _solvers()
    g_lam = torch.func.grad(lambda lm: torch.sum(solve(dict(data, lam=lm))[1] ** 2))(
        data["lam"])
    g_D = torch.func.grad(lambda d: torch.sum(torch.cos(solve(d)[1])))(data)["Dtsi"]
    _, _, udata, rng = unwrapped_data()
    s_rows = torch.as_tensor(rng.standard_normal(tuple(udata["mask"].shape))) * udata["mask"]
    udata = dict(udata, aux=(s_rows, torch.tensor(1.3, dtype=torch.float64)))
    usolve = make_implicit_unwrapped_solver(_wls_shard_prox, ADMMConfig(**dict(
        _CFG, nodualerror=True)), 64, 6, W)
    g_s = torch.func.grad(lambda d: torch.sum(usolve(d)[0] ** 2))(udata)["aux"][0]
    rc, init, out, res = run_ranks('''
        import test_torch_diff_sharded as M
        from admm_tpu_torch import ADMMConfig, make_implicit_consensus_solver
        from admm_tpu_torch import make_implicit_unwrapped_solver
        from admm_tpu_torch.parallel import make_mesh
        from admm_tpu_torch.parallel import consensus as TC
        g8 = make_mesh(M.W, group=mesh.group)
        _, _, data, _ = M.consensus_data()
        data = {k: (g8.take(v) if v.ndim else v) for k, v in data.items()}
        solve = make_implicit_consensus_solver(TC._lasso_local_prox, TC._lasso_global_prox,
                                               ADMMConfig(**M._CFG), M.N, M.W, mesh=g8)
        g_lam = torch.func.grad(lambda lm: torch.sum(solve(dict(data, lam=lm))[1] ** 2))(
            data["lam"])
        steps = list(solve.stats["steps"])
        g_D = torch.func.grad(lambda d: torch.sum(torch.cos(solve(d)[1])))(data)["Dtsi"]
        _, _, ud, rng = M.unwrapped_data()
        s_rows = torch.as_tensor(rng.standard_normal(tuple(ud["mask"].shape))) * ud["mask"]
        ud = {"Di": g8.take(ud["Di"]), "Winv": ud["Winv"], "mask": g8.take(ud["mask"]),
              "aux": (g8.take(s_rows), torch.tensor(1.3, dtype=torch.float64))}
        us = make_implicit_unwrapped_solver(M._wls_shard_prox, ADMMConfig(**dict(
            M._CFG, nodualerror=True)), 64, 6, M.W, mesh=g8)
        g_s = torch.func.grad(lambda d: torch.sum(us(d)[0] ** 2))(ud)["aux"][0]
        save(g_lam=g_lam, g_D=g_D, g_s=g_s, steps=np.asarray(steps))
    ''', tmp_path)
    check(rc, init, out)
    r0, r1 = res
    # The whole values are the same bits on both ranks; each rank holds its
    # block of the per-shard gradients.
    assert np.array_equal(r0["g_lam"], r1["g_lam"])
    assert r0["steps"].tolist() == r1["steps"].tolist()
    np.testing.assert_allclose(r0["g_lam"], float(g_lam), rtol=1e-9)
    for key, ref in (("g_D", g_D), ("g_s", g_s)):
        got = np.concatenate([r0[key], r1[key]])
        np.testing.assert_allclose(got, ref.numpy(), rtol=1e-8,
                                   atol=1e-8 * np.abs(ref.numpy()).max())


def test_gmres_gradients_over_two_processes(tmp_path):
    """vjp_method='gmres' over two ranks: every inner product of the
    Krylov solve adds the ranks' parts of the sharded leaves (one
    collective a Gram-Schmidt pass), so both ranks take the same restarts
    and stop together.  The consensus lambda gradient and the smooth
    unwrapped solver's per-shard gradient equal the stacked GMRES ones
    (1e-10) and admm_tpu's GMRES ones (1e-8); vmap of grad over the
    consensus solver over the ranks equals the stacked vmap (1e-10)."""
    _, _, data, jdata = consensus_data()
    solve, jsolve = _solvers(vjp_method="gmres")
    g_lam = torch.func.grad(lambda lm: torch.sum(solve(dict(data, lam=lm))[1] ** 2))(
        data["lam"])
    jg_lam = jax.grad(lambda lm: jnp.sum(jsolve(dict(jdata, lam=lm))[1] ** 2))(jdata["lam"])
    _, _, udata, rng = unwrapped_data()
    s_rows = torch.as_tensor(rng.standard_normal(tuple(udata["mask"].shape))) * udata["mask"]
    udata = dict(udata, aux=(s_rows, torch.tensor(1.3, dtype=torch.float64)))
    ucfg = dict(_CFG, nodualerror=True)
    usolve = make_implicit_unwrapped_solver(_wls_shard_prox, ADMMConfig(**ucfg), 64, 6, W,
                                            vjp_method="gmres")
    g_s = torch.func.grad(lambda d: torch.sum(usolve(d)[0] ** 2))(udata)["aux"][0]
    jus = j_unwrapped(_wls_shard_prox, JConfig(**ucfg), 64, 6, W, vjp_method="gmres")
    jg_s = jax.grad(lambda d: jnp.sum(jus(d)[0] ** 2))(_jax_data(udata))["aux"][0]
    rc, init, out, res = run_ranks('''
        import test_torch_diff_sharded as M
        from admm_tpu_torch import ADMMConfig, make_implicit_consensus_solver
        from admm_tpu_torch import make_implicit_unwrapped_solver
        from admm_tpu_torch.parallel import make_mesh
        from admm_tpu_torch.parallel import consensus as TC
        g8 = make_mesh(M.W, group=mesh.group)
        _, _, data, _ = M.consensus_data()
        data = {k: (g8.take(v) if v.ndim else v) for k, v in data.items()}
        solve = make_implicit_consensus_solver(TC._lasso_local_prox, TC._lasso_global_prox,
                                               ADMMConfig(**M._CFG), M.N, M.W, mesh=g8,
                                               vjp_method="gmres")
        g_lam = torch.func.grad(lambda lm: torch.sum(solve(dict(data, lam=lm))[1] ** 2))(
            data["lam"])
        cycles, reads = list(solve.stats["steps"]), solve.stats["reads"]
        g_vmap = torch.func.vmap(torch.func.grad(
            lambda lm: torch.sum(solve(dict(data, lam=lm))[1] ** 2)))(
            torch.tensor([0.2, 0.5], dtype=torch.float64))
        _, _, ud, rng = M.unwrapped_data()
        s_rows = torch.as_tensor(rng.standard_normal(tuple(ud["mask"].shape))) * ud["mask"]
        ud = {"Di": g8.take(ud["Di"]), "Winv": ud["Winv"], "mask": g8.take(ud["mask"]),
              "aux": (g8.take(s_rows), torch.tensor(1.3, dtype=torch.float64))}
        us = make_implicit_unwrapped_solver(M._wls_shard_prox, ADMMConfig(**dict(
            M._CFG, nodualerror=True)), 64, 6, M.W, mesh=g8, vjp_method="gmres")
        g_s = torch.func.grad(lambda d: torch.sum(us(d)[0] ** 2))(ud)["aux"][0]
        save(g_lam=g_lam, g_s=g_s, cycles=np.asarray(cycles + list(us.stats["steps"])),
             reads=reads, g_vmap=g_vmap)
    ''', tmp_path)
    check(rc, init, out)
    r0, r1 = res
    assert np.array_equal(r0["g_lam"], r1["g_lam"])
    assert r0["cycles"].tolist() == r1["cycles"].tolist() and int(r0["reads"]) == solve.stats[
        "reads"]
    np.testing.assert_allclose(r0["g_lam"], float(g_lam), rtol=1e-10)
    np.testing.assert_allclose(r0["g_lam"], float(jg_lam), rtol=1e-8)
    got = np.concatenate([r0["g_s"], r1["g_s"]])
    for ref, bar in ((g_s.numpy(), 1e-10), (np.asarray(jg_s), 1e-8)):
        np.testing.assert_allclose(got, ref, rtol=bar, atol=bar * np.abs(ref).max())
    # vmap(grad) over the ranks: the lanes' collectives one each for both
    # lanes (the vmap rules of the mesh's reductions), the stacked lanes.
    assert np.array_equal(r0["g_vmap"], r1["g_vmap"])
    g_vmap = torch.func.vmap(torch.func.grad(
        lambda lm: torch.sum(solve(dict(data, lam=lm))[1] ** 2)))(
        torch.tensor([0.2, 0.5], dtype=torch.float64))
    np.testing.assert_allclose(r0["g_vmap"], g_vmap.numpy(), rtol=1e-10)


@pytest.mark.parametrize("method", ["neumann", "gmres"])
def test_vmap_of_grad_over_the_sharded_solvers(method):
    """torch.func.vmap(torch.func.grad(loss)) over both sharded implicit
    solvers (8 stacked shards): the batch runs as lanes of the sharded
    runner and its backward as the lanes' adjoint; each lane equals its
    serial gradient (1e-8) and jax.vmap(jax.grad) of admm_tpu's (1e-8)."""
    _, _, data, jdata = consensus_data()
    solve, jsolve = _solvers(vjp_method=method)
    lams = torch.tensor([0.2, 0.3, 0.5], dtype=torch.float64)

    def loss(lm):
        return torch.sum(solve(dict(data, lam=lm))[1] ** 2)

    g = torch.func.vmap(torch.func.grad(loss))(lams)
    assert len(solve.stats["steps"]) == 3
    jg = jax.vmap(jax.grad(lambda lm: jnp.sum(jsolve(dict(jdata, lam=lm))[1] ** 2)))(
        jnp.asarray(lams.numpy()))
    for i in range(3):
        np.testing.assert_allclose(float(g[i]), float(torch.func.grad(loss)(lams[i])),
                                   rtol=1e-8)
    np.testing.assert_allclose(g.numpy(), np.asarray(jg), rtol=1e-8)

    _, _, udata, rng = unwrapped_data()
    s_rows = torch.as_tensor(rng.standard_normal(tuple(udata["mask"].shape))) * udata["mask"]
    ucfg = ADMMConfig(**dict(_CFG, nodualerror=True))
    usolve = make_implicit_unwrapped_solver(_wls_shard_prox, ucfg, 64, 6, W, vjp_method=method)
    gams = torch.tensor([0.8, 1.3], dtype=torch.float64)

    def uloss(gam):
        return torch.sum(usolve(dict(udata, aux=(s_rows, gam)))[0] ** 2)

    ug = torch.func.vmap(torch.func.grad(uloss))(gams)
    for i in range(2):
        np.testing.assert_allclose(float(ug[i]), float(torch.func.grad(uloss)(gams[i])),
                                   rtol=1e-8, atol=1e-12)
