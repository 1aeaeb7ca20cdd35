"""The distributed layer of the port (admm_tpu_torch.parallel) on a stacked
CPU mesh of 8 shards: the twins of tests/test_parallel.py, each holding
the port to the original's checks, and where the original's solve is the
point, to admm_tpu's run of it on its 8-device CPU mesh in f64 (equal
steps and flags, iterates and pnorm/dnorm histories within
tests/_parity.py's bar), on admm_tpu's carried setup (convert.py) and on
the port's own.  The reference test of JAX's setup cache
(test_consensus_lasso_setup_is_cached_across_solves) has no twin: the
port caches no setup."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import admm_tpu as J
import admm_tpu.parallel as JP
import admm_tpu_torch as T
import admm_tpu_torch.parallel as TP
from admm_tpu.parallel import consensus as JC
from admm_tpu.parallel import transpose_reduction as JTR
from admm_tpu_torch import convert
from admm_tpu_torch.parallel import consensus as TC
from admm_tpu_torch.parallel import transpose_reduction as TTR

from _parity import assert_same_lanes, assert_same_run

torch.set_num_threads(1)

CPU8 = TP.make_mesh(8, device="cpu")


def cpu_mesh(n):
    return TP.make_mesh(n, device="cpu")


@pytest.fixture(scope="module")
def ref():
    """admm_tpu's solves, each run once for the module: ``ref(key, fn)``."""
    cache = {}

    def get(key, fn):
        if key not in cache:
            cache[key] = fn()
        return cache[key]

    return get


def _lasso_instance(seed, rows, cols):
    rng = np.random.default_rng(seed)
    testx = rng.standard_normal(cols) * (rng.random(cols) < 0.6)
    D = rng.standard_normal((rows, cols))
    D = D / np.sqrt(np.sum(D**2, axis=0, keepdims=True))
    s = D @ testx + np.sqrt(0.001) * rng.standard_normal(rows)
    lam = 0.1 * np.max(np.abs(D.T @ s))
    return D, s, lam, testx


def _lasso_obj(D, s, lam, x):
    x = x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)
    return 0.5 * np.sum((D @ x - s) ** 2) + lam * np.sum(np.abs(x))


def _same_consensus(res, jres, rtol=1e-9):
    assert_same_run(res, jres, rtol)
    for key in ("xi", "ui"):
        ref = np.asarray(jres.extra[key])
        np.testing.assert_allclose(res.extra[key].numpy(), ref, rtol=rtol,
                                   atol=rtol * max(np.max(np.abs(ref)),
                                                   np.max(np.abs(np.asarray(jres.zopt)))))


def test_mesh_and_sharding_helpers():
    assert CPU8.size == 8 and CPU8.shape == (8,) and CPU8.device == torch.device("cpu")
    assert TP.make_mesh(device="cpu").size == 1  # one visible CPU device
    m2 = TP.make_mesh2d(2, 4, device="cpu")
    assert m2.shape == (2, 4) and m2.axis_names == ("lanes", "shards") and m2.size == 8
    M = np.arange(20).reshape(10, 2).astype(float)
    Mp, n_pad = TP.pad_rows(M, 8)
    Jp, jn = JP.pad_rows(M, 8)
    assert Mp.shape == (16, 2) and n_pad == jn == 6
    np.testing.assert_array_equal(Mp, Jp)
    blocks = TP.shard_rows(Mp, 8)
    assert blocks.shape == (8, 2, 2)
    np.testing.assert_array_equal(blocks, JP.shard_rows(Jp, 8))
    Mt, nt = TP.pad_rows(torch.as_tensor(M), 8)  # tensors stay tensors
    assert nt == 6 and isinstance(Mt, torch.Tensor)
    np.testing.assert_array_equal(TP.shard_rows(Mt, 8).numpy(), blocks)
    with pytest.raises(ValueError, match="pad_rows first"):
        TP.shard_rows(M, 8)


@pytest.mark.parametrize("nshards", [2, 8])
def test_consensus_lasso_agrees_with_serial(nshards, ref):
    D, s, lam, testx = _lasso_instance(0, 512, 32)
    cfg = dict(maxiters=5000)
    serial = T.lasso(D, s, lam, T.ADMMConfig(**cfg), device="cpu")
    par = TP.consensus_lasso(D, s, lam, T.ADMMConfig(**cfg), mesh=CPU8, nshards=nshards)
    assert par.steps < 5000 and par.extra["nshards"] == nshards
    f_serial = _lasso_obj(D, s, lam, serial.xopt)
    f_par = _lasso_obj(D, s, lam, par.zopt)
    assert abs(f_par - f_serial) <= 1e-2 * abs(f_serial)
    assert f_par < _lasso_obj(D, s, lam, testx)
    jres = ref(("lasso0", nshards), lambda: JP.consensus_lasso(
        D, s, lam, J.ADMMConfig(**cfg), mesh=JP.make_mesh(), nshards=nshards))
    _same_consensus(par, jres)


def test_consensus_padding_is_exact(ref):
    D, s, lam, _ = _lasso_instance(1, 509, 24)  # 509 % 8 != 0
    par = TP.consensus_lasso(D, s, lam, T.ADMMConfig(maxiters=5000), mesh=CPU8)
    ser = T.lasso(D, s, lam, T.ADMMConfig(maxiters=5000), device="cpu")
    f_par = _lasso_obj(D, s, lam, par.zopt)
    f_ser = _lasso_obj(D, s, lam, ser.xopt)
    assert abs(f_par - f_ser) <= 1e-2 * abs(f_ser)
    jres = ref("pad", lambda: JP.consensus_lasso(D, s, lam, J.ADMMConfig(maxiters=5000),
                                                 nshards=8))
    _same_consensus(par, jres)


def test_consensus_elasticnet_matches_serial_to_1e6():
    D, s, lam, _ = _lasso_instance(3, 512, 24)
    alpha = 0.6

    def obj(x):
        x = x.numpy()
        return (0.5 * np.sum((D @ x - s) ** 2)
                + lam * (alpha * np.sum(np.abs(x)) + 0.5 * (1 - alpha) * np.sum(x**2)))

    tight = T.ADMMConfig(maxiters=20000, abstol=1e-12, reltol=1e-12)
    serial = T.elasticnet(D, s, lam, alpha, tight, device="cpu")
    par = TP.consensus_elasticnet(D, s, lam, alpha, tight, mesh=CPU8)
    assert par.steps < 20000 and not par.diverged
    f_serial, f_par = obj(serial.xopt), obj(par.zopt)
    assert abs(f_par - f_serial) <= 1e-6 * abs(f_serial), (f_par, f_serial)


def test_consensus_elasticnet_alpha1_is_consensus_lasso(ref):
    D, s, lam, _ = _lasso_instance(4, 256, 16)
    cfg = T.ADMMConfig(maxiters=3000)
    a = TP.consensus_elasticnet(D, s, lam, 1.0, cfg, mesh=CPU8)
    b = TP.consensus_lasso(D, s, lam, cfg, mesh=CPU8)
    assert a.steps == b.steps
    torch.testing.assert_close(a.zopt, b.zopt, rtol=0, atol=0)
    jres = ref("en1", lambda: JP.consensus_elasticnet(D, s, lam, 1.0, J.ADMMConfig(maxiters=3000),
                                                      nshards=8))
    _same_consensus(a, jres)


def _ridge_local(z, ui, rho, d):
    rhs = d["Dtsi"] + rho * (z[None, :] - ui)
    return torch.einsum("wij,wj->wi", d["Minv"], rhs)


def _ridge_global(xbar, ubar, rho, W, d):
    return (xbar + ubar) * (rho * W) / (rho * W + d["lam"])


def _jridge_local(z, ui, rho, d):
    rhs = d["Dtsi"] + rho * (z[None, :] - ui)
    return jnp.einsum("wij,wj->wi", d["Minv"], rhs)


def _jridge_global(xbar, ubar, rho, W, d):
    return (xbar + ubar) * (rho * W) / (rho * W + d["lam"])


def test_generic_consensus_admm_ridge():
    """The generic runner with a ridge global prox reaches the closed form,
    and equals admm_tpu's on the same per-shard data."""
    rng = np.random.default_rng(5)
    W, mi, n = 8, 64, 24
    lam = 0.7
    D = rng.standard_normal((W * mi, n))
    s = rng.standard_normal(W * mi)
    x_closed = np.linalg.solve(D.T @ D + lam * np.eye(n), D.T @ s)
    Di, si = TP.shard_rows(D, W), TP.shard_rows(s, W)
    G = np.einsum("wij,wik->wjk", Di, Di) + np.eye(n)[None]
    data = {"Minv": np.linalg.inv(G), "Dtsi": np.einsum("wij,wi->wj", Di, si),
            "lam": np.float64(lam)}
    res = TP.consensus_admm(_ridge_local, _ridge_global, data, n, T.ADMMConfig(maxiters=5000),
                            mesh=CPU8, nshards=W)
    np.testing.assert_allclose(res.zopt.numpy(), x_closed, atol=1e-3)
    jres = JP.consensus_admm(_jridge_local, _jridge_global,
                             {k: jnp.asarray(v) for k, v in data.items()}, n,
                             J.ADMMConfig(maxiters=5000), nshards=W)
    _same_consensus(res, jres)


def _svm_instance(seed, mpos, mneg, sep):
    rng = np.random.default_rng(seed)
    bp = np.linspace(0, 2, mpos)
    bn = np.linspace(0, 2, mneg)
    pos = np.stack([bp + rng.random(mpos) - sep * rng.random(mpos),
                    bp - rng.random(mpos) + sep * rng.random(mpos)], 1)
    neg = np.stack([bn - rng.random(mneg) + sep * rng.random(mneg),
                    bn + rng.random(mneg) - sep * rng.random(mneg)], 1)
    return np.concatenate([pos, neg]), np.concatenate([np.ones(mpos), -np.ones(mneg)])


def _jax_start(seed, n, m, W):
    """admm_tpu's default random start of the sharded SVM (jax.random over
    the padded rows), cut to the true rows: carried to the port's x0/z0/u0."""
    mp = -(-m // W) * W
    kx, kz, ku = jax.random.split(jax.random.PRNGKey(seed), 3)
    return (np.asarray(jax.random.uniform(kx, (n,), dtype=jnp.float64)),
            np.asarray(jax.random.uniform(kz, (mp,), dtype=jnp.float64))[:m],
            np.asarray(jax.random.uniform(ku, (mp,), dtype=jnp.float64))[:m])


@pytest.mark.parametrize("loss", ["hinge", "01"])
def test_sharded_svm_agrees_with_serial(loss):
    D, ell = _svm_instance(0, 128, 128, 0.5)
    cfg = dict(maxiters=1000)
    res = TP.linearsvm_sharded(D, ell, 1.0, T.ADMMConfig(**cfg), loss=loss, mesh=CPU8)
    x = res.xopt.numpy()
    assert abs(1.0 - (-x[1] / x[0])) <= 0.05
    serial = T.linearsvm(D, ell, 1.0, T.ADMMConfig(**cfg), loss=loss, device="cpu")
    xs = serial.xopt.numpy()
    assert abs((-x[1] / x[0]) - (-xs[1] / xs[0])) <= 0.05
    # admm_tpu's default-start run, its start carried across.
    x0, z0, u0 = _jax_start(0, 2, 256, 8)
    jres = JP.linearsvm_sharded(D, ell, 1.0, J.ADMMConfig(**cfg), loss=loss)
    carried = TP.linearsvm_sharded(D, ell, 1.0, T.ADMMConfig(**cfg), loss=loss, mesh=CPU8,
                                   x0=x0, z0=z0, u0=u0)
    assert_same_run(carried, jres, rtol=1e-9 if loss == "hinge" else 1e-7)


def test_sharded_svm_padding():
    D, ell = _svm_instance(0, 100, 101, 0.5)  # 201 rows -> pads to 208
    res = TP.linearsvm_sharded(D, ell, 1.0, T.ADMMConfig(maxiters=1000), mesh=CPU8)
    x = res.xopt.numpy()
    assert abs(1.0 - (-x[1] / x[0])) <= 0.06
    assert res.extra["n_pad"] == 7 and res.zopt.shape == (8, 26)
    assert float(res.zopt.reshape(-1)[201:].abs().max()) == 0.0  # masked pad rows


def test_sliced_prox_matches_direct():
    n = 64
    slice_len = n // 8

    def prox_slice(x, z, u, rho, k):
        return (z - u)[k * slice_len:(k + 1) * slice_len] * rho

    prox = TP.make_sliced_prox(prox_slice, slice_len, CPU8)
    rng = np.random.default_rng(0)
    x, z, u = (torch.as_tensor(rng.standard_normal(n)) for _ in range(3))
    torch.testing.assert_close(prox(x, z, u, 1.7), 1.7 * (z - u), rtol=0, atol=1e-12)


def _model_pair(seed, n, rho=1.0):
    rng = np.random.default_rng(seed)
    P, Q = rng.standard_normal((n, n)), rng.standard_normal((n, n))
    r, s = rng.standard_normal(n), rng.standard_normal(n)
    PtPinv = torch.as_tensor(np.linalg.inv(P.T @ P + rho * np.eye(n)))
    QtQinv = torch.as_tensor(np.linalg.inv(Q.T @ Q + rho * np.eye(n)))
    truex = np.linalg.solve(P.T @ P + Q.T @ Q, P.T @ r + Q.T @ s)
    return PtPinv, QtQinv, torch.as_tensor(P.T @ r), torch.as_tensor(Q.T @ s), truex


def _rows_of(M, starts, L):
    Mp = torch.nn.functional.pad(M, (0, 0, 0, L))
    return lambda k: Mp[int(starts[k]):int(starts[k]) + L]


def test_sliced_prox_inside_engine():
    n = 64
    PtPinv, QtQinv, Ptr, Qts, truex = _model_pair(3, n)
    slice_len = n // 8

    def prox_f_slice(x, z, u, rho, k):
        return PtPinv[k * slice_len:(k + 1) * slice_len] @ (Ptr + rho * (z - u))

    prox_f = TP.make_sliced_prox(prox_f_slice, slice_len, CPU8)
    prox_g = lambda x, z, u, rho: QtQinv @ (Qts + rho * (x + u))  # noqa: E731
    res = T.admm(prox_f, prox_g, T.ADMMConfig(maxiters=5000), A=1.0, B=-1.0, c=0.0, m=n,
                 dtype=torch.float64, device="cpu")
    np.testing.assert_allclose(res.xopt.numpy(), truex, atol=1e-3)


def test_consensus_relaxation_converges(ref):
    D, s, lam, _ = _lasso_instance(2, 512, 32)
    base = TP.consensus_lasso(D, s, lam, T.ADMMConfig(maxiters=5000), mesh=CPU8)
    rel = TP.consensus_lasso(D, s, lam, T.ADMMConfig(maxiters=5000, relax=1.5), mesh=CPU8)
    f_base, f_rel = _lasso_obj(D, s, lam, base.zopt), _lasso_obj(D, s, lam, rel.zopt)
    assert abs(f_rel - f_base) <= 1e-2 * abs(f_base)
    assert rel.steps <= base.steps + 5
    jres = ref("relax", lambda: JP.consensus_lasso(D, s, lam,
                                                   J.ADMMConfig(maxiters=5000, relax=1.5)))
    _same_consensus(rel, jres)


def test_consensus_hnorm_stopping_and_history(ref):
    D, s, lam, _ = _lasso_instance(3, 512, 32)
    cfg = dict(maxiters=5000, stopcond="both", convtest=True)
    res = TP.consensus_lasso(D, s, lam, T.ADMMConfig(**cfg), mesh=CPU8)
    assert not res.diverged
    assert res.Hnormsq is not None and len(res.Hnormsq) == res.steps
    assert res.steps < 5000
    h = res.Hnormsq
    assert h[-1] < h[0]
    jres = ref("hnorm", lambda: JP.consensus_lasso(D, s, lam, J.ADMMConfig(**cfg)))
    _same_consensus(res, jres)


def test_consensus_warm_start_resumes(ref):
    D, s, lam, _ = _lasso_instance(4, 512, 32)
    cold = TP.consensus_lasso(D, s, lam, T.ADMMConfig(maxiters=5000), mesh=CPU8)
    pre = TP.consensus_lasso(D, s, lam, T.ADMMConfig(maxiters=20, domaxiters=True), mesh=CPU8)
    resumed = TP.consensus_lasso(D, s, lam, T.ADMMConfig(maxiters=5000), mesh=CPU8,
                                 xi0=pre.extra["xi"], ui0=pre.extra["ui"], z0=pre.zopt)
    f_cold, f_res = _lasso_obj(D, s, lam, cold.zopt), _lasso_obj(D, s, lam, resumed.zopt)
    assert abs(f_res - f_cold) <= 1e-3 * abs(f_cold)
    assert resumed.steps < cold.steps
    jpre = ref("pre", lambda: JP.consensus_lasso(D, s, lam,
                                                 J.ADMMConfig(maxiters=20, domaxiters=True)))
    _same_consensus(pre, jpre)
    jres = JP.consensus_lasso(D, s, lam, J.ADMMConfig(maxiters=5000), xi0=jpre.extra["xi"],
                              ui0=jpre.extra["ui"], z0=jpre.zopt)
    _same_consensus(resumed, jres)


def _nan_local(z, ui, rho, d):
    return (z[None, :] - ui) * d["scale"]


def _ok_global(xbar, ubar, rho, W, d):
    return xbar + ubar


def test_consensus_nan_flags_diverged():
    res = TP.consensus_admm(_nan_local, _ok_global, {"scale": np.nan}, 8,
                            T.ADMMConfig(maxiters=50), mesh=CPU8)
    assert res.diverged and res.steps < 50


def test_consensus_fast_matches_stacked_engine(ref):
    """Fast/accelerated consensus IS the core engine on the stacked
    splitting x = [x_1..x_W], A = I, B = -[I;..;I]: the port's engine on
    that formulation is the oracle, and admm_tpu's consensus run the
    parity reference."""
    from admm_tpu_torch.ops.prox import soft_threshold

    rng = np.random.default_rng(11)
    W, n, m = 4, 12, 64
    D = rng.standard_normal((m, n))
    s = rng.standard_normal(m)
    lam = 0.1 * np.max(np.abs(D.T @ s))
    Di, si = D.reshape(W, m // W, n), s.reshape(W, m // W)
    Minv = torch.as_tensor(np.linalg.inv(np.einsum("wij,wik->wjk", Di, Di) + np.eye(n)[None]))
    Dtsi = torch.as_tensor(np.einsum("wij,wi->wj", Di, si))

    def pf(x, z, u, rho_):
        return torch.einsum("wij,wj->wi", Minv, Dtsi + rho_ * (z[None, :] - u.reshape(W, n))
                            ).reshape(W * n)

    def pg(x, z, u, rho_):
        return soft_threshold(x.reshape(W, n).mean(0) + u.reshape(W, n).mean(0), lam / (rho_ * W))

    Bmat = -np.tile(np.eye(n), (W, 1))
    for variant, compare_steps in (
            (dict(fast=True, fasttype="weak"), True),
            (dict(fast=True, fasttype="strong", domaxiters=True, maxiters=60), False),
            (dict(fast=True, fasttype="weak", relax=1.3), True)):
        cfg = {"maxiters": 300, **variant}
        eng = T.admm(pf, pg, T.ADMMConfig(**cfg), A=1.0, B=Bmat, c=0.0, m=W * n, nA=W * n,
                     nB=n, dtype=torch.float64, device="cpu")
        con = TP.consensus_lasso(D, s, lam, T.ADMMConfig(**cfg), mesh=CPU8, nshards=W)
        if compare_steps:
            assert con.steps == eng.steps
            np.testing.assert_allclose(con.dvals, eng.dvals, rtol=1e-9, atol=1e-12)
        np.testing.assert_allclose(con.zopt.numpy(), eng.zopt.numpy(), rtol=1e-9, atol=1e-11)
        np.testing.assert_allclose(con.xopt.numpy(), eng.xopt.reshape(W, n).mean(0).numpy(),
                                   rtol=1e-9, atol=1e-11)
        jres = ref(("fast", str(variant)), lambda: JP.consensus_lasso(
            D, s, lam, J.ADMMConfig(**cfg), nshards=W))
        _same_consensus(con, jres)


def test_sliced_prox_uneven_slices_match_unsliced():
    from admm_tpu_torch.utils.validate import slicemaker

    n = 1000
    lengths = [300, 200, 150, 100, 100, 75, 50, 25]
    starts = np.concatenate([[0], np.cumsum(lengths)[:-1]])
    L = max(lengths)

    def make(starts, L):
        def prox_slice(x, z, u, rho, k):
            v = torch.nn.functional.pad(z - u, (0, L))
            return v[int(starts[k]):int(starts[k]) + L] * rho
        return prox_slice

    prox = TP.make_sliced_prox(make(starts, L), lengths, CPU8)
    rng = np.random.default_rng(0)
    x, z, u = (torch.as_tensor(rng.standard_normal(n)) for _ in range(3))
    torch.testing.assert_close(prox(x, z, u, 1.7), 1.7 * (z - u), rtol=0, atol=0)
    bal = slicemaker(0, n, 8)
    assert bal == [125] * 8
    bstarts = np.concatenate([[0], np.cumsum(bal)[:-1]])
    prox2 = TP.make_sliced_prox(make(bstarts, max(bal)), bal, CPU8)
    torch.testing.assert_close(prox2(x, z, u, 2.0), 2.0 * (z - u), rtol=0, atol=0)
    # Fewer slices than shards: the missing ones are not computed.
    three = TP.make_sliced_prox(make([0, 400, 800], 400), [400, 400, 200], CPU8)
    torch.testing.assert_close(three(x, z, u, 2.0), 2.0 * (z - u), rtol=0, atol=0)


def _uneven_model(seed, n, lengths):
    PtPinv, QtQinv, Ptr, Qts, truex = _model_pair(seed, n)
    starts = np.concatenate([[0], np.cumsum(lengths)[:-1]])
    L = max(lengths)
    Prow, Qrow = _rows_of(PtPinv, starts, L), _rows_of(QtQinv, starts, L)

    def prox_f_slice(x, z, u, rho, k):
        return Prow(k) @ (Ptr + rho * (z - u))

    def prox_g_slice(x, z, u, rho, k):
        return Qrow(k) @ (Qts + rho * (x + u))

    def prox_g(x, z, u, rho):
        return QtQinv @ (Qts + rho * (x + u))

    def prox_f(x, z, u, rho):
        return PtPinv @ (Ptr + rho * (z - u))

    return prox_f_slice, prox_g_slice, prox_f, prox_g, truex


def test_parallel_both_inside_engine():
    from admm_tpu_torch.utils.validate import slicemaker

    n = 100
    lengths = slicemaker(0, n, 8)
    assert len(set(lengths)) > 1
    pfs, pgs, pf, pg, truex = _uneven_model(6, n, lengths)
    prox_f, prox_g = TP.make_parallel_proxes(pfs, pgs, "both", (lengths, lengths), nx=n, nz=n,
                                             mesh=CPU8)
    cfg = T.ADMMConfig(maxiters=5000)
    res = T.admm(prox_f, prox_g, cfg, A=1.0, B=-1.0, c=0.0, m=n, dtype=torch.float64,
                 device="cpu")
    np.testing.assert_allclose(res.xopt.numpy(), truex, atol=1e-3)
    plain = T.admm(pf, pg, cfg, A=1.0, B=-1.0, c=0.0, m=n, dtype=torch.float64, device="cpu")
    assert res.steps == plain.steps
    np.testing.assert_allclose(res.xopt.numpy(), plain.xopt.numpy(), rtol=1e-12, atol=1e-13)


def test_parallel_proxes_validation():
    def f(x, z, u, rho, k):
        return x

    with pytest.raises(ValueError, match="xminf"):
        TP.make_parallel_proxes(f, f, "bogus", 0, nx=8, nz=8, mesh=CPU8)
    with pytest.raises(ValueError, match="both"):
        TP.make_parallel_proxes(f, f, "xminf", ([4, 4], [4, 4]), nx=8, nz=8, mesh=CPU8)
    with pytest.raises(ValueError, match="slicesx"):
        TP.make_parallel_proxes(f, f, "both", 0, nx=8, nz=8, mesh=CPU8)
    with pytest.raises(ValueError, match="mesh devices"):
        TP.make_sliced_prox(f, [1] * 9, CPU8)
    with pytest.raises(ValueError, match="positive"):
        TP.make_sliced_prox(f, 0, CPU8)


def test_engine_parallel_kwarg():
    n = 96
    lengths = [20, 16, 12, 12, 12, 12, 8, 4]
    pfs, _, _, pg, truex = _uneven_model(9, n, lengths)
    cfg = T.ADMMConfig(maxiters=5000)
    res = T.admm(pfs, pg, cfg, A=1.0, B=-1.0, c=0.0, m=n, parallel="xminf", slices=lengths,
                 mesh=CPU8, dtype=torch.float64, device="cpu")
    np.testing.assert_allclose(res.xopt.numpy(), truex, atol=1e-3)
    with pytest.raises(ValueError, match="data"):
        T.admm(pfs, pg, cfg, A=1.0, B=-1.0, c=0.0, m=n, parallel="xminf", slices=lengths,
               mesh=CPU8, data={"x": torch.zeros(2)}, dtype=torch.float64, device="cpu")
    with pytest.raises(ValueError, match="1-D"):
        T.admm(pfs, pg, cfg, shape_x=(4, 4), shape_z=(4, 4), parallel="xminf", slices=4,
               mesh=CPU8, dtype=torch.float64, device="cpu")


def test_consensus_and_sharded_unroll_exact():
    D, s, lam, _ = _lasso_instance(7, 512, 32)
    base = TP.consensus_lasso(D, s, lam, T.ADMMConfig(maxiters=1001), mesh=CPU8)
    un = TP.consensus_lasso(D, s, lam, T.ADMMConfig(maxiters=1001, unroll=4), mesh=CPU8)
    assert un.steps == base.steps
    torch.testing.assert_close(un.zopt, base.zopt, rtol=0, atol=0)
    Dsvm, ell = _svm_instance(1, 64, 64, 0.5)
    b2 = TP.linearsvm_sharded(Dsvm, ell, 1.0, T.ADMMConfig(maxiters=501), mesh=CPU8)
    u2 = TP.linearsvm_sharded(Dsvm, ell, 1.0, T.ADMMConfig(maxiters=501, unroll=3), mesh=CPU8)
    assert u2.steps == b2.steps
    torch.testing.assert_close(u2.xopt, b2.xopt, rtol=0, atol=0)


def test_engine_parallel_composes_with_unroll():
    n = 64
    slice_len = n // 8
    PtPinv, QtQinv, Ptr, Qts, _ = _model_pair(11, n)

    def prox_f_slice(x, z, u, rho, k):
        return PtPinv[k * slice_len:(k + 1) * slice_len] @ (Ptr + rho * (z - u))

    def prox_f_full(x, z, u, rho):
        return PtPinv @ (Ptr + rho * (z - u))

    def prox_g(x, z, u, rho):
        return QtQinv @ (Qts + rho * (x + u))

    kw = dict(A=1.0, B=-1.0, c=0.0, m=n, dtype=torch.float64, device="cpu")
    r1 = T.admm(prox_f_slice, prox_g, T.ADMMConfig(maxiters=3000), parallel="xminf",
                slices=slice_len, mesh=CPU8, **kw)
    rK = T.admm(prox_f_slice, prox_g, T.ADMMConfig(maxiters=3000, unroll=4), parallel="xminf",
                slices=slice_len, mesh=CPU8, **kw)
    assert rK.steps == r1.steps
    torch.testing.assert_close(rK.xopt, r1.xopt, rtol=0, atol=0)
    cfg_fast = T.ADMMConfig(maxiters=3000, fast=True)
    rf_sliced = T.admm(prox_f_slice, prox_g, cfg_fast, parallel="xminf", slices=slice_len,
                       mesh=CPU8, **kw)
    rf_plain = T.admm(prox_f_full, prox_g, cfg_fast, **kw)
    assert rf_sliced.steps == rf_plain.steps
    np.testing.assert_allclose(rf_sliced.xopt.numpy(), rf_plain.xopt.numpy(), rtol=1e-12,
                               atol=1e-13)


def _jax_rows_of(M, starts, L):
    Mp, sd = jnp.pad(jnp.asarray(M), ((0, L), (0, 0))), jnp.asarray(starts)
    return lambda k: jax.lax.dynamic_slice_in_dim(Mp, sd[k], L)


@pytest.mark.parametrize("n,spec", [(64, 8), (100, 0)], ids=["even", "uneven"])
@pytest.mark.parametrize("mode", ["xminf", "zming", "both"])
def test_engine_parallel_matches_admm_tpu(mode, n, spec):
    """admm(parallel=mode, slices=spec) against admm_tpu's on its 8-device
    CPU mesh, f64, the same per-slice proxes of the model problem: 8
    slices of 8 (a block size), or slicemaker's even split of 100 over 8
    (13 x 4 + 12 x 4)."""
    from admm_tpu.utils.validate import slicemaker as jax_slicemaker
    from admm_tpu_torch.utils.validate import slicemaker

    lengths = slicemaker(spec, n, 8)
    assert lengths == jax_slicemaker(spec, n, 8)
    starts = np.concatenate([[0], np.cumsum(lengths)[:-1]])
    L = max(lengths)
    PtPinv, QtQinv, Ptr, Qts, _ = _model_pair(13, n)
    mats = {"f": (PtPinv, Ptr), "g": (QtQinv, Qts)}
    sign = {"f": lambda x, z, u: z - u, "g": lambda x, z, u: x + u}

    def torch_prox(which, sliced):
        M, b = mats[which]
        if not sliced:
            return lambda x, z, u, rho: M @ (b + rho * sign[which](x, z, u))
        rows = _rows_of(M, starts, L)
        return lambda x, z, u, rho, k: rows(k) @ (b + rho * sign[which](x, z, u))

    def jax_prox(which, sliced):
        M, b = (jnp.asarray(v.numpy()) for v in mats[which])
        if not sliced:
            return lambda x, z, u, rho: M @ (b + rho * sign[which](x, z, u))
        rows = _jax_rows_of(M, starts, L)
        return lambda x, z, u, rho, k: rows(k) @ (b + rho * sign[which](x, z, u))

    sl = {"f": mode in ("xminf", "both"), "g": mode in ("zming", "both")}
    slices = (spec, spec) if mode == "both" else spec
    cfg = dict(maxiters=5000, stopcond="both", convtest=True)
    jres = J.admm(jax_prox("f", sl["f"]), jax_prox("g", sl["g"]), J.ADMMConfig(**cfg), A=1.0,
                  B=-1.0, c=0.0, m=n, dtype=jnp.float64, parallel=mode, slices=slices,
                  mesh=JP.make_mesh(8))
    res = T.admm(torch_prox("f", sl["f"]), torch_prox("g", sl["g"]), T.ADMMConfig(**cfg),
                 A=1.0, B=-1.0, c=0.0, m=n, dtype=torch.float64, device="cpu", parallel=mode,
                 slices=slices, mesh=CPU8)
    assert 10 < res.steps < 5000
    assert_same_run(res, jres)


def _svm_variant_problem(seed=0, m=96, n=10):
    rng = np.random.default_rng(seed)
    D = rng.standard_normal((m, n))
    ell = np.sign(rng.standard_normal(m))
    return D, ell, rng.uniform(size=n), rng.uniform(size=m), rng.uniform(size=m)


@pytest.mark.parametrize("variant", [
    dict(),
    dict(relax=1.5),
    dict(fast=True, fasttype="strong", maxiters=100, domaxiters=True),
    dict(fast=True, fasttype="weak"),
    dict(stopcond="both", convtest=True),
])
def test_sharded_unwrapped_matches_serial_per_variant(variant):
    D, ell, x0, z0, u0 = _svm_variant_problem()
    cfg = {"maxiters": 400, **variant}
    serial = T.linearsvm(D, ell, 0.7, T.ADMMConfig(**cfg), x0=x0, z0=z0, u0=u0, device="cpu")
    sharded = TP.linearsvm_sharded(D, ell, 0.7, T.ADMMConfig(**cfg), mesh=CPU8, nshards=4,
                                   x0=x0, z0=z0, u0=u0)
    assert sharded.steps == serial.steps
    np.testing.assert_allclose(sharded.xopt.numpy(), serial.xopt.numpy(), rtol=1e-8, atol=1e-8)
    np.testing.assert_allclose(sharded.pnorm, serial.pnorm, rtol=1e-6, atol=1e-9)
    jres = JP.linearsvm_sharded(D, ell, 0.7, J.ADMMConfig(**cfg), nshards=4, x0=x0, z0=z0, u0=u0)
    assert_same_run(sharded, jres, rtol=1e-8 if variant.get("fasttype") == "strong" else 1e-9)


def test_sharded_unwrapped_dual_stop_and_rbadaptive_match_serial():
    from admm_tpu_torch.models.linearsvm import _obj_hinge, _prox_g_hinge

    D, ell, x0, z0, u0 = _svm_variant_problem(seed=3)
    C = 0.7
    cfg = dict(maxiters=400, stopcond="both", rbadaptive=True)
    serial = T.unwrappedadmm(_prox_g_hinge, D, T.ADMMConfig(**cfg), obj=_obj_hinge,
                             data={"D": torch.as_tensor(D), "ell": torch.as_tensor(ell),
                                   "C": torch.tensor(C, dtype=torch.float64)},
                             x0=x0, z0=z0, u0=u0, nodualerror=False, device="cpu")
    aux = (ell, np.ones_like(ell), np.full_like(ell, C))
    sharded = TP.unwrapped_admm_sharded(
        TTR._svm_prox_hinge, D, T.ADMMConfig(**cfg, nodualerror=False), aux=aux,
        obj_shard=TTR._svm_obj_hinge, obj_global=TTR._svm_obj_global, mesh=CPU8, nshards=4,
        x0=x0, z0=z0, u0=u0)
    assert sharded.steps == serial.steps
    assert sharded.rho_final == pytest.approx(serial.rho_final, rel=1e-12)
    np.testing.assert_allclose(sharded.xopt.numpy(), serial.xopt.numpy(), rtol=1e-8, atol=1e-9)
    np.testing.assert_allclose(sharded.dnorm, serial.dnorm, rtol=1e-6, atol=1e-9)
    jres = JP.unwrapped_admm_sharded(
        JTR._svm_prox_hinge, D, J.ADMMConfig(**cfg, nodualerror=False), aux=aux,
        obj_shard=JTR._svm_obj_hinge, obj_global=JTR._svm_obj_global, nshards=4,
        x0=x0, z0=z0, u0=u0)
    assert_same_run(sharded, jres)


def test_sharded_unwrapped_results_accessors_and_validation():
    D, ell, x0, z0, u0 = _svm_variant_problem(seed=7)
    res = TP.linearsvm_sharded(D, ell, 0.7, T.ADMMConfig(maxiters=50), mesh=CPU8, nshards=4)
    assert np.isnan(res.dnorm).all() and np.isnan(res.derr).all()
    for kw in (dict(x0=x0[:-1]), dict(z0=z0[:-1]), dict(u0=u0[:-1])):
        with pytest.raises(ValueError, match="must have shape"):
            TP.linearsvm_sharded(D, ell, 0.7, T.ADMMConfig(maxiters=10), mesh=CPU8, nshards=4,
                                 **kw)
    with pytest.raises(ValueError, match="multiple of the mesh size"):
        TP.linearsvm_sharded(D, ell, 0.7, mesh=CPU8, nshards=12)


def test_sharded_unwrapped_unroll_is_exact():
    D, ell, x0, z0, u0 = _svm_variant_problem(seed=5)
    kw = dict(mesh=CPU8, nshards=4, x0=x0, z0=z0, u0=u0)
    for variant in (dict(), dict(fast=True, fasttype="weak")):
        r1 = TP.linearsvm_sharded(D, ell, 0.7, T.ADMMConfig(maxiters=150, **variant), **kw)
        r4 = TP.linearsvm_sharded(D, ell, 0.7, T.ADMMConfig(maxiters=150, unroll=4, **variant),
                                  **kw)
        assert r4.steps == r1.steps
        torch.testing.assert_close(r4.xopt, r1.xopt, rtol=0, atol=0)


def test_linearsvm_wrapper_parallel_routes_to_sharded():
    D, ell, x0, z0, u0 = _svm_variant_problem(seed=9)
    cfg = T.ADMMConfig(maxiters=200)
    kw = dict(x0=x0, z0=z0, u0=u0)
    via = T.linearsvm(D, ell, 0.7, cfg, parallel=True, nshards=4, mesh=CPU8, **kw)
    direct = TP.linearsvm_sharded(D, ell, 0.7, cfg, mesh=CPU8, nshards=4, **kw)
    assert via.steps == direct.steps
    torch.testing.assert_close(via.xopt, direct.xopt, rtol=0, atol=0)
    # The default start: without padding, the serial solver's own.
    serial = T.linearsvm(D, ell, 0.7, cfg, device="cpu")
    dflt = T.linearsvm(D, ell, 0.7, cfg, parallel=True, nshards=4, mesh=CPU8)
    assert dflt.steps == serial.steps
    np.testing.assert_allclose(dflt.xopt.numpy(), serial.xopt.numpy(), rtol=1e-8, atol=1e-9)
    jres = J.linearsvm(D, ell, 0.7, J.ADMMConfig(maxiters=200), parallel=True, nshards=4, **kw)
    assert_same_run(via, jres)


def test_lasso_wrapper_parallel_routes_to_consensus():
    D, s, lam, _ = _lasso_instance(3, 96, 12)
    cfg = T.ADMMConfig(maxiters=300)
    via = T.lasso(D, s, lam, cfg, parallel=True, nshards=4, mesh=CPU8)
    direct = TP.consensus_lasso(D, s, lam, cfg, mesh=CPU8, nshards=4)
    assert via.steps == direct.steps
    torch.testing.assert_close(via.zopt, direct.zopt, rtol=0, atol=0)
    with pytest.raises(ValueError, match="per-shard"):
        T.lasso(D, s, lam, cfg, parallel=True, nshards=4, mesh=CPU8, x0=np.zeros(12))
    with pytest.raises(ValueError, match="serial-path"):
        T.lasso(D, s, lam, cfg, parallel=True, nshards=4, mesh=CPU8, use_fused_kernel=True)
    jres = J.lasso(D, s, lam, J.ADMMConfig(maxiters=300), parallel=True, nshards=4)
    _same_consensus(via, jres)


def test_sharded_runners_record_iterates():
    D, s, lam, _ = _lasso_instance(5, 96, 12)
    cfg = T.ADMMConfig(maxiters=100, record_iterates=True)
    res = TP.consensus_lasso(D, s, lam, cfg, mesh=CPU8, nshards=4)
    k = res.steps
    assert res.hist["xvals"].shape == (100, 12) and res.hist["wvals"].shape == (100, 36)
    torch.testing.assert_close(res.hist["xvals"][k - 1], res.xopt, rtol=0, atol=0)
    torch.testing.assert_close(res.hist["zvals"][k - 1], res.zopt, rtol=0, atol=0)
    jres = JP.consensus_lasso(D, s, lam, J.ADMMConfig(maxiters=100, record_iterates=True),
                              nshards=4)
    for name in ("xvals", "zvals", "uvals", "wvals"):
        ref = np.asarray(jres.hist[name])[:k]
        np.testing.assert_allclose(res.hist[name][:k].numpy(), ref, rtol=1e-9,
                                   atol=1e-9 * np.max(np.abs(ref)))
    ell = np.sign(s)
    res2 = TP.linearsvm_sharded(D, ell, 0.7, cfg, mesh=CPU8, nshards=4)
    torch.testing.assert_close(res2.hist["xvals"][res2.steps - 1], res2.xopt, rtol=0, atol=0)
    cfg_rb = T.ADMMConfig(maxiters=40, domaxiters=True, rbadaptive=True, record_iterates=True)
    res3 = TP.consensus_lasso(D, s, lam, cfg_rb, mesh=CPU8, nshards=4)
    np.testing.assert_allclose(res3.hist["uvals"][res3.steps - 1].numpy(), res3.uopt.numpy(),
                               rtol=1e-12, atol=1e-15)
    cfg_f = T.ADMMConfig(maxiters=40, domaxiters=True, fast=True, record_iterates=True)
    res4 = TP.consensus_lasso(D, s, lam, cfg_f, mesh=CPU8, nshards=4)
    assert res4.hist["vvals"].shape == (40, 12)


def test_consensus_lasso_batch_lane_exact_2d_mesh():
    rng = np.random.default_rng(5)
    m, n, B = 64, 10, 4
    D = rng.standard_normal((m, n))
    S = rng.standard_normal((B, m))
    lams = np.geomspace(0.05, 0.4, B)
    cfg = dict(maxiters=500)
    mesh2 = TP.make_mesh2d(2, 4, device="cpu")
    batch = TP.consensus_lasso_batch(D, S, lams, T.ADMMConfig(**cfg), mesh=mesh2)
    for b in range(B):
        solo = TP.consensus_lasso(D, S[b], float(lams[b]), T.ADMMConfig(**cfg),
                                  mesh=cpu_mesh(4), nshards=4)
        assert int(batch.steps[b]) == solo.steps
        np.testing.assert_allclose(batch.zopt[b].numpy(), solo.zopt.numpy(), rtol=1e-10,
                                   atol=1e-12)
        np.testing.assert_allclose(batch.xopt[b].numpy(), solo.xopt.numpy(), rtol=1e-10,
                                   atol=1e-12)
    assert batch.hist["pnorm"].shape == (B, 500)
    jres = JP.consensus_lasso_batch(D, S, lams, J.ADMMConfig(**cfg), mesh=JP.make_mesh2d(2, 4))
    assert_same_lanes(batch, jres)


def test_consensus_lasso_batch_dynamic_rho_and_validation():
    rng = np.random.default_rng(6)
    D = rng.standard_normal((48, 8))
    S = rng.standard_normal((4, 48))
    mesh22 = TP.make_mesh2d(2, 2, device="cpu")
    res = TP.consensus_lasso_batch(D, S, 0.1, T.ADMMConfig(maxiters=200, rbadaptive=True),
                                   mesh=mesh22)
    assert torch.isfinite(res.zopt).all() and tuple(res.steps.shape) == (4,)
    jres = JP.consensus_lasso_batch(D, S, 0.1, J.ADMMConfig(maxiters=200, rbadaptive=True),
                                    mesh=JP.make_mesh2d(2, 2))
    assert_same_lanes(res, jres)
    np.testing.assert_allclose(res.rho_final.numpy(), np.asarray(jres.rho_final), rtol=1e-12)
    with pytest.raises(ValueError, match="2-D"):
        TP.consensus_lasso_batch(D, S, 0.1, mesh=cpu_mesh(4))
    with pytest.raises(ValueError, match="divide over"):
        TP.consensus_lasso_batch(D, S[:3], 0.1, mesh=mesh22)
    with pytest.raises(ValueError, match="signal lanes"):
        TP.consensus_lasso_batch(D, S[:, :20], 0.1, mesh=mesh22)


def test_consensus_lasso_batch_warm_start_resumes():
    rng = np.random.default_rng(8)
    D = rng.standard_normal((48, 8))
    S = rng.standard_normal((4, 48))
    mesh = TP.make_mesh2d(2, 2, device="cpu")
    cfg = T.ADMMConfig(maxiters=400)
    full = TP.consensus_lasso_batch(D, S, 0.2, cfg, mesh=mesh)
    resumed = TP.consensus_lasso_batch(D, S, 0.2, cfg, mesh=mesh, xi0=full.extra["xi"],
                                       ui0=full.extra["ui"], z0=full.zopt)
    assert int(resumed.steps.max()) <= 3
    np.testing.assert_allclose(resumed.zopt.numpy(), full.zopt.numpy(), atol=1e-3)
    for b in range(4):
        obj = lambda z: 0.5 * np.sum((D @ z - S[b]) ** 2) + 0.2 * np.sum(np.abs(z))  # noqa: E731
        zf, zr = full.zopt[b].numpy(), resumed.zopt[b].numpy()
        assert abs(obj(zr) - obj(zf)) <= 1e-4 * (1.0 + abs(obj(zf)))


def test_consensus_elasticnet_batch_2d_mesh():
    rng = np.random.default_rng(10)
    D = rng.standard_normal((48, 8))
    S = rng.standard_normal((4, 48))
    lams = np.geomspace(0.05, 0.3, 4)
    mesh = TP.make_mesh2d(2, 2, device="cpu")
    cfg = T.ADMMConfig(maxiters=400)
    en1 = TP.consensus_elasticnet_batch(D, S, lams, 1.0, cfg, mesh=mesh)
    la = TP.consensus_lasso_batch(D, S, lams, cfg, mesh=mesh)
    assert en1.steps.tolist() == la.steps.tolist()
    np.testing.assert_allclose(en1.zopt.numpy(), la.zopt.numpy(), rtol=1e-12, atol=1e-14)
    alphas = np.array([0.3, 0.6, 0.8, 1.0])
    enb = TP.consensus_elasticnet_batch(D, S, lams, alphas, cfg, mesh=mesh)
    for b in range(4):
        solo = TP.consensus_elasticnet(D, S[b], float(lams[b]), float(alphas[b]), cfg,
                                       mesh=cpu_mesh(2), nshards=2)
        assert int(enb.steps[b]) == solo.steps
        np.testing.assert_allclose(enb.zopt[b].numpy(), solo.zopt.numpy(), rtol=1e-10,
                                   atol=1e-12)
    jres = JP.consensus_elasticnet_batch(D, S, lams, alphas, J.ADMMConfig(maxiters=400),
                                         mesh=JP.make_mesh2d(2, 2))
    assert_same_lanes(enb, jres)
    with pytest.raises(ValueError, match="alphas"):
        TP.consensus_elasticnet_batch(D, S, lams, 1.5, cfg, mesh=mesh)


def test_sharded_runners_stall_detector():
    rng = np.random.default_rng(12)
    D = rng.standard_normal((128, 16)).astype(np.float32)
    s = rng.standard_normal(128).astype(np.float32)
    kw = dict(maxiters=3000, abstol=1e-13, reltol=1e-13)
    res = TP.consensus_lasso(D, s, 0.1, T.ADMMConfig(stallwindow=50, **kw), mesh=CPU8,
                             nshards=4)
    assert res.stalled and res.steps < 3000
    from admm_tpu_torch.testers.problems import make_svm_instance

    Ds, ell = make_svm_instance(0, 64, 64, 0.5)
    rs = TP.linearsvm_sharded(Ds.astype(np.float32), ell.astype(np.float32), 1.0,
                              T.ADMMConfig(stallwindow=50, stopcond="both", hnormtol=1e-30, **kw),
                              mesh=CPU8, nshards=4)
    assert rs.stalled and rs.steps < 3000
    ok = TP.consensus_lasso(D.astype(np.float64), s.astype(np.float64), 0.1,
                            T.ADMMConfig(maxiters=3000, stallwindow=200), mesh=CPU8, nshards=4)
    assert not ok.stalled and ok.steps < 3000


def test_svm_batch_sharded_lane_exact_2d_mesh():
    from admm_tpu_torch.testers.problems import make_svm_instance

    D, _ = make_svm_instance(0, 96, 96, 0.5)
    rng = np.random.default_rng(3)
    y = rng.integers(0, 4, size=D.shape[0])
    ells = np.stack([np.where(y == k, 1.0, -1.0) for k in range(4)])
    cfg = dict(maxiters=300)
    mesh = TP.make_mesh2d(2, 4, device="cpu")
    x0, z0, u0 = rng.random((4, 2)), rng.random((4, D.shape[0])), rng.random((4, D.shape[0]))
    batch = TP.svm_batch_sharded(D, ells, 1.0, T.ADMMConfig(**cfg), mesh=mesh, nshards=4,
                                 x0=x0, z0=z0, u0=u0)
    for b in range(4):
        solo = TP.linearsvm_sharded(D, ells[b], 1.0, T.ADMMConfig(**cfg), mesh=cpu_mesh(4),
                                    nshards=4, x0=x0[b], z0=z0[b], u0=u0[b])
        assert int(batch.steps[b]) == solo.steps
        np.testing.assert_allclose(batch.xopt[b].numpy(), solo.xopt.numpy(), rtol=1e-9,
                                   atol=1e-11)
        assert float(batch.objopt[b]) == pytest.approx(solo.objopt, rel=1e-12)
    jres = JP.svm_batch_sharded(D, ells, 1.0, J.ADMMConfig(**cfg), mesh=JP.make_mesh2d(2, 4),
                                nshards=4, x0=x0, z0=z0, u0=u0)
    assert_same_lanes(batch, jres)
    b2 = TP.svm_batch_sharded(D, ells, 1.0, T.ADMMConfig(**cfg), mesh=mesh, nshards=4)
    x = b2.xopt.numpy()
    assert np.isfinite(x).all() and x.shape == (4, 2)
    assert not np.allclose(x[0], x[1])
    with pytest.raises(ValueError, match="2-D"):
        TP.svm_batch_sharded(D, ells, 1.0, mesh=cpu_mesh(4))
    with pytest.raises(ValueError, match="label lanes"):
        TP.svm_batch_sharded(D, ells[:, :10], 1.0, mesh=mesh)


# ---- carried setup: admm_tpu's per-shard state through the port's iteration


@pytest.mark.parametrize("variant", [dict(), dict(rbadaptive=True), dict(anderson=5),
                                     dict(fast=True, unroll=4)])
def test_consensus_on_carried_setup(variant):
    """admm_tpu's sharded setup (Minv or V/w, and Dtsi) carried across with
    convert.consensus_data: the port's iteration on the same numbers as
    admm_tpu's, so only the iteration's rounding differs."""
    D, s, lam, _ = _lasso_instance(13, 203, 20)  # 203 % 8 != 0: padded
    cfg = {"maxiters": 600, **variant}
    jcfg = J.ADMMConfig(**cfg)
    local, data, n, mesh, W = JC._sharded_ls_setup(D, s, jcfg, JP.make_mesh(), 8)
    data = dict(data, lam=jnp.asarray(lam))
    jres = JP.consensus_admm(local, JC._lasso_global_prox, data, n, jcfg, nshards=W)
    tdata, _ = convert.consensus_data(convert.numpy_state(data))
    tlocal = TC._lasso_local_prox_dynamic if "V" in tdata else TC._lasso_local_prox
    res = TP.consensus_admm(tlocal, TC._lasso_global_prox, tdata, n, T.ADMMConfig(**cfg),
                            mesh=CPU8)
    _same_consensus(res, jres, rtol=1e-9)


def test_unwrapped_on_carried_setup():
    """admm_tpu's W^+, mask, aux and random start carried across with
    convert.unwrapped_sharded_data into the port's transpose-reduction
    iteration."""
    D, ell = _svm_instance(2, 61, 60, 0.5)  # 121 rows over 8 shards: padded
    W, (m, n) = 8, D.shape
    jcfg = J.ADMMConfig(maxiters=500, stopcond="both", nodualerror=True)
    jres = JP.linearsvm_sharded(D, ell, 1.0, jcfg, nshards=W)
    Di = JP.shard_rows(JP.pad_rows(D, W)[0], W)
    mrow = np.zeros(Di.shape[0] * Di.shape[1])
    mrow[:m] = 1.0
    pad = lambda a: JP.shard_rows(JP.pad_rows(a, W)[0], W)  # noqa: E731
    kx, kz, ku = jax.random.split(jax.random.PRNGKey(0), 3)
    mp = mrow.shape[0]
    state = convert.numpy_state(
        {"Di": Di, "Winv": JTR._gram_pinv(jnp.asarray(Di)), "mask": JP.shard_rows(mrow, W),
         "aux": (pad(ell), pad(np.ones(m)), pad(np.full(m, 1.0)))},
        x0=jax.random.uniform(kx, (n,), dtype=jnp.float64),
        z0=jax.random.uniform(kz, (mp,), dtype=jnp.float64).reshape(W, -1),
        u0=jax.random.uniform(ku, (mp,), dtype=jnp.float64).reshape(W, -1))
    data, warm = convert.unwrapped_sharded_data(state)
    out = TTR._unwrapped_solve(TTR._svm_prox_hinge, TTR._svm_obj_hinge, TTR._svm_obj_global,
                               T.ADMMConfig(maxiters=500, stopcond="both", nodualerror=True,
                                            unroll=1), m, data, warm["x0"], warm["z0"],
                               warm["u0"])
    res = T.ADMMResults.from_raw(out, None)
    assert_same_run(res, jres)


def test_public_names_cover_admm_tpu_parallel():
    """admm_tpu.parallel.__all__, every name bound and every one running;
    admm_tpu_torch.parallel is reachable as admm_tpu.parallel is.  The two
    cluster names run as admm_tpu's do on one process: nothing joined,
    the visible devices counted, the stacked mesh over them
    (tests/test_torch_multihost.py joins processes)."""
    assert set(JP.__all__) <= set(TP.__all__)
    assert all(getattr(TP, name) is not None for name in TP.__all__)
    assert T.parallel is TP
    assert TP.initialize_cluster(device="cpu") == 1
    mesh = TP.global_mesh(device="cpu")
    assert mesh.shape == (1,) and mesh.group is None and mesh.device == torch.device("cpu")
