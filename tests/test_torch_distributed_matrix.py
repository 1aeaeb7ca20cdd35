"""The port's distributed matrix-iterate runners on a stacked CPU mesh of
8 shards: the twins of tests/test_distributed_matrix.py (the sharded SDP,
parallel/sdp.py, and consensus covariance selection, parallel/consensus.py)
and consensus logistic regression, each held to the original's oracles
(the serial solves) and to admm_tpu's run on its 8-device CPU mesh in f64
(equal steps, iterates and histories within tests/_parity.py's bar), on
admm_tpu's carried setup (convert.py) and on the port's own."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec

import admm_tpu as J
import admm_tpu.parallel as JP
import admm_tpu_torch as T
import admm_tpu_torch.parallel as TP
from admm_tpu.parallel import consensus as JC
from admm_tpu.parallel import sdp as JS
from admm_tpu_torch import convert
from admm_tpu_torch.models.covarianceselection import _obj as _covsel_obj
from admm_tpu_torch.models.covarianceselection import empirical_covariance
from admm_tpu_torch.models.sdp import random_sdp_instance
from admm_tpu_torch.parallel import consensus as TC
from admm_tpu_torch.parallel import sdp as TS

from _parity import assert_same_lanes, assert_same_run

torch.set_num_threads(1)

CPU8 = TP.make_mesh(8, device="cpu")
_KW = dict(maxiters=20000, abstol=1e-10, reltol=1e-10)


class TestShardedSDP:
    def test_matches_serial_bit_for_bit(self, rng):
        C, A, b, Xstar, _, _ = random_sdp_instance(10, 12, 4, rng)
        ser = T.sdp(C, A, b, config=T.ADMMConfig(**_KW), device="cpu")
        sh = TP.sdp_sharded(C, A, b, config=T.ADMMConfig(**_KW), mesh=CPU8)  # m=12: pads
        assert sh.steps == ser.steps
        np.testing.assert_allclose(sh.zopt.numpy(), ser.zopt.numpy(), rtol=1e-12, atol=1e-13)
        np.testing.assert_allclose(sh.zopt.numpy(), Xstar, atol=1e-4)
        assert_same_run(sh, JP.sdp_sharded(C, A, b, config=J.ADMMConfig(**_KW)))

    def test_ns_projection_and_submesh(self, rng):
        C, A, b, Xstar, _, _ = random_sdp_instance(8, 6, 3, rng)
        pstar = float(np.sum(C * Xstar))
        cfg = dict(maxiters=5000, abstol=1e-8, reltol=1e-8)
        res = TP.sdp_sharded(C, A, b, config=T.ADMMConfig(**cfg), mesh=CPU8, nshards=4,
                             prox_method="ns", ns_iters=40)
        obj = float(np.sum(C * res.zopt.numpy()))
        assert abs(obj - pstar) <= 1e-2 * max(1.0, abs(pstar))
        assert res.extra["nshards"] == 4 and res.extra["mesh"].size == 4
        assert_same_run(res, JP.sdp_sharded(C, A, b, config=J.ADMMConfig(**cfg), nshards=4,
                                            prox_method="ns", ns_iters=40))

    def test_warm_start_resumes(self, rng):
        C, A, b, *_ = random_sdp_instance(8, 5, 3, rng)
        cold = TP.sdp_sharded(C, A, b, config=T.ADMMConfig(**_KW), mesh=CPU8)
        warm = TP.sdp_sharded(C, A, b, config=T.ADMMConfig(**_KW), mesh=CPU8, x0=cold.xopt,
                              z0=cold.zopt, u0=cold.uopt)
        assert warm.steps <= max(3, cold.steps // 10)

    def test_engine_variants_run_sharded(self, rng):
        # The weak mode runs to its cap (its restarts keep the d-value
        # stop away); the twin caps it at 4000 steps, where both variants
        # sit at the optimum far inside the bar.
        C, A, b, Xstar, _, _ = random_sdp_instance(8, 6, 3, rng)
        for variant in (dict(relax=1.5), dict(fast=True, fasttype="weak")):
            res = TP.sdp_sharded(C, A, b, config=T.ADMMConfig(**{**_KW, "maxiters": 4000},
                                                              **variant), mesh=CPU8)
            np.testing.assert_allclose(res.zopt.numpy(), Xstar, atol=1e-4)

    def test_validation(self, rng):
        C = np.eye(4)
        with pytest.raises(ValueError, match="diag"):
            TP.sdp_sharded(C, "diag", np.ones(4), mesh=CPU8)
        with pytest.raises(ValueError, match="ns_delta"):
            TP.sdp_sharded(C, np.zeros((2, 4, 4)), np.ones(2), prox_method="ns", ns_correct=1,
                           mesh=CPU8)
        A1 = rng.standard_normal((4, 4))
        A1 = 0.5 * (A1 + A1.T)
        with pytest.raises(ValueError, match="dependent"):
            TP.sdp_sharded(C, np.stack([A1, 2.0 * A1]), np.ones(2), mesh=CPU8)

    def test_on_carried_setup(self, rng):
        """admm_tpu's padded stack and Gram factor carried across with
        convert.program_data into the port's sharded prox."""
        C, A, b, *_ = random_sdp_instance(8, 10, 3, rng)
        W, m, n = 8, 10, 8
        mw = -(-m // W)
        A4 = np.zeros((mw * W, n, n))
        A4[:m] = 0.5 * (A + np.swapaxes(A, -1, -2))
        A4 = A4.reshape(W, mw, n, n)
        bpad, pad_diag = np.zeros(mw * W), np.zeros(mw * W)
        bpad[:m], pad_diag[m:] = b, 1.0
        L = JS._cached_gram_setup(NamedSharding(JP.make_mesh(), PartitionSpec("shards")))(
            jnp.asarray(A4), jnp.asarray(pad_diag))
        cfg = dict(maxiters=3000, abstol=1e-9, reltol=1e-9)
        jres = JP.sdp_sharded(C, A, b, config=J.ADMMConfig(**cfg))
        data, _ = convert.program_data(convert.numpy_state(
            {"C": 0.5 * (C + C.T), "A": A4, "bpad": bpad, "L": L}))
        res = T.admm(TS._prox_f_sharded, TS._prox_g, T.ADMMConfig(**cfg, unroll=1), A=1.0,
                     B=-1.0, c=0.0, shape_x=(n, n), shape_z=(n, n), dtype=torch.float64,
                     data=data, hooks=T.Hooks(obj=TS._obj), device="cpu")
        assert_same_run(res, jres)


def _covsel_instance(rng, p=16, m=200):
    Sinv = np.eye(p) + 0.3 * np.triu((rng.random((p, p)) < 0.1) * rng.standard_normal((p, p)), 1)
    Sinv = Sinv @ Sinv.T
    L = np.linalg.cholesky(np.linalg.inv(Sinv))
    return rng.standard_normal((m, p)) @ L.T


def _graphical_lasso_obj(D, lam, res):
    S = empirical_covariance(torch.as_tensor(D))
    return float(_covsel_obj(res.xopt, res.zopt, {"S": S, "lam": torch.tensor(lam)}))


class TestConsensusCovsel:
    def test_matches_serial_optimum(self, rng):
        D = _covsel_instance(rng)
        lam = 0.1
        ser = T.covarianceselection(D, lam, T.ADMMConfig(**_KW), device="cpu")
        con = TP.consensus_covsel(D, lam, T.ADMMConfig(**_KW), mesh=CPU8, nshards=4)
        f_ser, f_con = _graphical_lasso_obj(D, lam, ser), _graphical_lasso_obj(D, lam, con)
        assert abs(f_con - f_ser) <= 1e-6 * (1.0 + abs(f_ser))
        np.testing.assert_allclose(con.zopt.numpy(), ser.zopt.numpy(), atol=1e-3)
        assert not con.diverged
        jres = JP.consensus_covsel(D, lam, J.ADMMConfig(**_KW), nshards=4)
        assert_same_run(con, jres)
        np.testing.assert_allclose(con.extra["xi"].numpy(), np.asarray(jres.extra["xi"]),
                                   rtol=1e-9, atol=1e-9)

    def test_ns_matches_eigh(self, rng):
        D = _covsel_instance(rng)
        eigh = TP.consensus_covsel(D, 0.1, T.ADMMConfig(**_KW), mesh=CPU8, nshards=4)
        ns = TP.consensus_covsel(D, 0.1, T.ADMMConfig(**_KW), mesh=CPU8, nshards=4,
                                 prox_method="ns", ns_iters=30)
        assert ns.steps == eigh.steps
        np.testing.assert_allclose(ns.zopt.numpy(), eigh.zopt.numpy(), atol=1e-9)
        assert_same_run(ns, JP.consensus_covsel(D, 0.1, J.ADMMConfig(**_KW), nshards=4,
                                                prox_method="ns", ns_iters=30))

    def test_more_shards_than_devices_and_8(self, rng):
        D = _covsel_instance(rng, p=12, m=160)
        lam = 0.15
        f_ser = _graphical_lasso_obj(D, lam, T.covarianceselection(D, lam, T.ADMMConfig(**_KW),
                                                                   device="cpu"))
        for W in (8, 16):
            con = TP.consensus_covsel(D, lam, T.ADMMConfig(**_KW), mesh=CPU8, nshards=W)
            assert abs(_graphical_lasso_obj(D, lam, con) - f_ser) <= 1e-5 * (1.0 + abs(f_ser)), W

    def test_warm_start_resumes(self, rng):
        D = _covsel_instance(rng, p=10, m=120)
        cold = TP.consensus_covsel(D, 0.1, T.ADMMConfig(**_KW), mesh=CPU8, nshards=4)
        warm = TP.consensus_covsel(D, 0.1, T.ADMMConfig(**_KW), mesh=CPU8, nshards=4,
                                   xi0=cold.extra["xi"], ui0=cold.extra["ui"], z0=cold.zopt)
        assert warm.steps <= max(3, cold.steps // 5)

    def test_matrix_warm_start_shape_validation(self, rng):
        D = _covsel_instance(rng, p=10, m=120)
        with pytest.raises(ValueError, match="xi0"):
            TP.consensus_covsel(D, 0.1, T.ADMMConfig(**_KW), mesh=CPU8, nshards=4,
                                xi0=np.zeros((4, 10)))
        with pytest.raises(ValueError, match="prox_method"):
            TP.consensus_covsel(D, 0.1, T.ADMMConfig(**_KW), mesh=CPU8, prox_method="qr")

    def test_fast_mode_reaches_optimum(self, rng):
        D = _covsel_instance(rng, p=12, m=160)
        lam = 0.1
        f_ser = _graphical_lasso_obj(D, lam, T.covarianceselection(D, lam, T.ADMMConfig(**_KW),
                                                                   device="cpu"))
        # Capped at 4000 steps as the SDP's weak-mode twin is.
        con = TP.consensus_covsel(D, lam, T.ADMMConfig(**{**_KW, "maxiters": 4000}, fast=True,
                                                       fasttype="weak"), mesh=CPU8, nshards=4)
        assert abs(_graphical_lasso_obj(D, lam, con) - f_ser) <= 1e-5 * (1.0 + abs(f_ser))

    def test_on_carried_setup(self, rng):
        """admm_tpu's per-shard covariance contributions S_i carried across
        with convert.consensus_data into the port's eigh local prox."""
        D = _covsel_instance(rng, p=8, m=90)
        W, (m, p) = 8, D.shape
        Dc = (D - D.mean(0)) / np.sqrt(m - 1)
        Di = JP.shard_rows(JP.pad_rows(Dc, W)[0], W)
        Si = JC._cached_covsel_setup(NamedSharding(JP.make_mesh(), PartitionSpec("shards")))(
            jnp.asarray(Di))
        cfg = dict(maxiters=2000, abstol=1e-9, reltol=1e-9)
        jdata = {"Si": Si, "lam": jnp.asarray(0.1), "wgt": jnp.asarray(1.0 / W)}
        jres = JP.consensus_admm(JC._covsel_local_prox, JC._lasso_global_prox, jdata, p * p,
                                 J.ADMMConfig(**cfg), nshards=W)
        data, _ = convert.consensus_data(convert.numpy_state(jdata))
        res = TP.consensus_admm(TC._covsel_local_prox, TC._lasso_global_prox, data, p * p,
                                T.ADMMConfig(**cfg), mesh=CPU8)
        assert_same_run(res, jres)


class TestConsensusCovselBatch:
    def test_lanes_match_solo_consensus(self, rng):
        B, m, p, W = 4, 160, 10, 4
        Ds = np.stack([_covsel_instance(rng, p=p, m=m) for _ in range(B)])
        lams = np.geomspace(0.05, 0.2, B)
        cfg = dict(maxiters=20000, abstol=1e-9, reltol=1e-9)
        batch = TP.consensus_covsel_batch(Ds, lams, T.ADMMConfig(**cfg),
                                          mesh=TP.make_mesh2d(2, 4, device="cpu"), nshards=W)
        for b in range(B):
            solo = TP.consensus_covsel(Ds[b], float(lams[b]), T.ADMMConfig(**cfg),
                                       mesh=TP.make_mesh(W, device="cpu"), nshards=W)
            assert int(batch.steps[b]) == solo.steps
            np.testing.assert_allclose(batch.zopt[b].numpy(), solo.zopt.numpy(), rtol=1e-12,
                                       atol=1e-14)
        assert tuple(batch.extra["xi"].shape) == (B, W, p, p)
        jres = JP.consensus_covsel_batch(Ds, lams, J.ADMMConfig(**cfg),
                                         mesh=JP.make_mesh2d(2, 4), nshards=W)
        assert_same_lanes(batch, jres)

    def test_ns_mode_and_warm_start(self, rng):
        B, m, p, W = 2, 120, 8, 4
        Ds = np.stack([_covsel_instance(rng, p=p, m=m) for _ in range(B)])
        cfg = T.ADMMConfig(maxiters=20000, abstol=1e-9, reltol=1e-9)
        mesh2 = TP.make_mesh2d(2, 4, device="cpu")
        eigh = TP.consensus_covsel_batch(Ds, 0.1, cfg, mesh=mesh2, nshards=W)
        ns = TP.consensus_covsel_batch(Ds, 0.1, cfg, mesh=mesh2, nshards=W, prox_method="ns",
                                       ns_iters=30)
        np.testing.assert_allclose(ns.zopt.numpy(), eigh.zopt.numpy(), atol=1e-8)
        warm = TP.consensus_covsel_batch(Ds, 0.1, cfg, mesh=mesh2, nshards=W,
                                         xi0=eigh.extra["xi"], ui0=eigh.extra["ui"],
                                         z0=eigh.zopt)
        assert int(warm.steps.max()) <= max(3, int(eigh.steps.max()) // 5)

    def test_validation(self, rng):
        mesh2 = TP.make_mesh2d(2, 4, device="cpu")
        with pytest.raises(ValueError, match="divide"):
            TP.consensus_covsel_batch(np.zeros((3, 20, 4)), 0.1, mesh=mesh2)
        with pytest.raises(ValueError, match="2-D"):
            TP.consensus_covsel_batch(np.zeros((2, 20, 4)), 0.1, mesh=CPU8)
        with pytest.raises(ValueError, match="prox_method"):
            TP.consensus_covsel_batch(np.zeros((2, 20, 4)), 0.1, mesh=mesh2, prox_method="qr")


@pytest.mark.parametrize("inner", ["newton", "newton_cg"])
def test_consensus_logreg_matches_admm_tpu_and_serial(inner):
    """Consensus sparse logistic regression (parallel/consensus.py, beyond
    the reference): admm_tpu's run in f64 to the parity bar, and the
    serial logreg's objective."""
    rng = np.random.default_rng(4)
    m, n = 203, 10  # 203 rows over 8 shards: padded
    D = rng.standard_normal((m, n))
    ell = np.sign(D @ rng.standard_normal(n) + 0.3 * rng.standard_normal(m))
    cfg = dict(maxiters=3000, abstol=1e-8, reltol=1e-8)
    kw = dict(inner=inner, newton_steps=8, cg_steps=8)
    res = TP.consensus_logreg(D, ell, 0.5, T.ADMMConfig(**cfg), mesh=CPU8, **kw)
    jres = JP.consensus_logreg(D, ell, 0.5, J.ADMMConfig(**cfg), **kw)
    assert res.steps < 3000 and not res.diverged
    assert_same_run(res, jres, rtol=1e-7)
    ser = T.logreg(D, ell, 0.5, T.ADMMConfig(**cfg), device="cpu")

    def f(z):
        z = z.numpy()
        return np.sum(np.logaddexp(0.0, -ell * (D @ z))) + 0.5 * np.sum(np.abs(z))

    assert abs(f(res.zopt) - f(ser.zopt)) <= 1e-3 * abs(f(ser.zopt))
