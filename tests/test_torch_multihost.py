"""The port's multi-process tests: the twins of tests/test_multihost.py's
six, with two OS processes joined by one gloo process group on the CPU
(``initialize_cluster``, a file rendezvous, ``global_mesh``), each rank
holding its block of the shards.  Each worker checks what the original's
does, and both ranks hold the same steps, histories and results bit for
bit; a failure after the group is joined fails the test, and a worker
that dies after joining must not be masked (the skip guard's own test).
The tolerances are the originals'."""

import pytest
import torch

from _torch_ranks import check, run_ranks, same_on_every_rank

torch.set_num_threads(1)


def test_consensus_lasso_across_two_processes(tmp_path):
    """consensus_lasso over a mesh spanning two processes (each rank's
    rows, the means all-reduced) agrees with the serial solve, plain and
    accelerated."""
    got = run_ranks('''
        from admm_tpu_torch import ADMMConfig, lasso
        from admm_tpu_torch.models._common import host64
        from admm_tpu_torch.parallel import consensus_lasso, make_mesh
        assert mesh.world == 2 and mesh.size == 2
        rng = np.random.default_rng(0)
        D = rng.standard_normal((64, 8))
        s = rng.standard_normal(64)
        g4 = make_mesh(4, group=mesh.group)     # two shards a rank
        res = consensus_lasso(D, s, 0.1, ADMMConfig(maxiters=500), mesh=g4)
        z = host64(res.zopt)
        assert np.isfinite(z).all() and res.steps > 0
        obj = lambda x: 0.5 * np.sum((D @ x - s) ** 2) + 0.1 * np.sum(np.abs(x))
        ser = lasso(D, s, 0.1, ADMMConfig(maxiters=2000), device="cpu")
        f_par, f_ser = obj(z), obj(host64(ser.xopt))
        assert abs(f_par - f_ser) <= 1e-2 * abs(f_ser), (f_par, f_ser)
        resf = consensus_lasso(D, s, 0.1, ADMMConfig(maxiters=500, fast=True), mesh=g4)
        zf = host64(resf.zopt)
        assert np.isfinite(zf).all()
        assert abs(obj(zf) - f_ser) <= 5e-2 * abs(f_ser), (obj(zf), f_ser)
        save(steps=res.steps, pnorm=res.hist["pnorm"], dnorm=res.hist["dnorm"],
             fsteps=resf.steps, fpnorm=resf.hist["pnorm"], z=res.zopt)
    ''', tmp_path)
    check(*got)
    same_on_every_rank(got[3])


def test_sharded_svm_across_two_processes(tmp_path):
    """The transpose-reduction SVM over two processes is the serial
    unwrapped iteration: from the same start, the serial solve's steps and
    separator (f64, 1e-8)."""
    got = run_ranks('''
        from admm_tpu_torch import ADMMConfig, linearsvm
        from admm_tpu_torch.models._common import host64
        from admm_tpu_torch.parallel import linearsvm_sharded, make_mesh
        from admm_tpu_torch.testers.problems import make_svm_instance
        D, ell = make_svm_instance(0, 64, 64, 0.5)
        cfg = ADMMConfig(maxiters=300)
        res = linearsvm_sharded(D, ell, 1.0, cfg, mesh=make_mesh(4, group=mesh.group), seed=3)
        x = host64(res.xopt)
        assert np.isfinite(x).all()
        assert x[0] > 0 and x[1] < 0
        ser = linearsvm(D, ell, 1.0, cfg, seed=3, device="cpu")
        assert res.steps == ser.steps, (res.steps, ser.steps)
        np.testing.assert_allclose(x, host64(ser.xopt), rtol=1e-8, atol=1e-8)
        save(steps=res.steps, pnorm=res.hist["pnorm"], x=res.xopt, z=res.zopt)
    ''', tmp_path)
    check(*got)
    same_on_every_rank(got[3])


def test_sliced_prox_across_two_processes(tmp_path):
    """Engine-generic sliced proxes over a mesh spanning two processes:
    uneven slices reassemble exactly."""
    got = run_ranks('''
        from admm_tpu_torch.parallel import make_mesh, make_sliced_prox
        from admm_tpu_torch.utils.validate import slicemaker
        g4 = make_mesh(4, group=mesh.group)     # 4 positions over 2 processes
        n = 4 * 4 + 3
        lengths = slicemaker(0, n, 4)
        starts = np.concatenate([[0], np.cumsum(lengths)[:-1]])
        L = max(lengths)
        def prox_slice(x, z, u, rho, k):
            v = torch.nn.functional.pad(z - u, (0, L))
            return v[int(starts[k]):int(starts[k]) + L] * rho
        prox = make_sliced_prox(prox_slice, lengths, g4)
        rng = np.random.default_rng(0)
        zv = torch.as_tensor(rng.standard_normal(n).astype(np.float32))
        uv = torch.as_tensor(rng.standard_normal(n).astype(np.float32))
        out = prox(zv, zv, uv, 1.5)
        assert torch.equal(out, 1.5 * (zv - uv))
        save(out=out)
    ''', tmp_path)
    check(*got)
    same_on_every_rank(got[3])


def test_worker_failure_is_not_masked(tmp_path):
    """A worker that dies after joining the group fails the test: the
    skip guard cannot eat a real regression."""
    rc, initialized, output, _ = run_ranks('''
        assert False, "deliberate post-init failure"
    ''', tmp_path)
    if rc != 0 and not initialized:
        pytest.skip("torch.distributed (gloo) unavailable in this environment")
    assert rc != 0 and initialized
    with pytest.raises(AssertionError, match="regression"):
        check(rc, initialized, output)


def test_consensus_batch_2d_mesh_across_two_processes(tmp_path):
    """The lanes x shards program over two processes, the lanes over the
    ranks and every shard of a lane on its rank: each lane at its serial
    solve's objective, the results whole on both ranks."""
    got = run_ranks('''
        from admm_tpu_torch import ADMMConfig, lasso
        from admm_tpu_torch.models._common import host64
        from admm_tpu_torch.parallel import consensus_lasso_batch, make_mesh2d
        rng = np.random.default_rng(0)
        D = rng.standard_normal((64, 8))
        S = rng.standard_normal((4, 64))
        lams = np.geomspace(0.05, 0.3, 4)
        batch = consensus_lasso_batch(D, S, lams, ADMMConfig(maxiters=400),
                                      mesh=make_mesh2d(2, 2, group=mesh.group))
        steps, zopt = batch.steps.numpy(), host64(batch.zopt)
        assert np.isfinite(zopt).all()
        assert steps.shape == (4,) and (steps > 0).all()
        for b in range(4):
            ser = lasso(D, S[b], float(lams[b]), ADMMConfig(maxiters=3000), device="cpu")
            obj = lambda x: 0.5 * np.sum((D @ x - S[b]) ** 2) + lams[b] * np.sum(np.abs(x))
            f_b, f_s = obj(zopt[b]), obj(host64(ser.xopt))
            assert abs(f_b - f_s) <= 1e-2 * (1.0 + abs(f_s)), (b, f_b, f_s)
        save(steps=batch.steps, pnorm=batch.hist["pnorm"], z=batch.zopt, xi=batch.extra["xi"])
    ''', tmp_path)
    check(*got)
    same_on_every_rank(got[3])


def test_matrix_iterate_runners_across_two_processes(tmp_path):
    """The sharded SDP (each rank's constraint block, the residuals
    gathered, the correction summed) and consensus covariance selection
    over two processes, both at their serial solves."""
    got = run_ranks('''
        from admm_tpu_torch import ADMMConfig, sdp
        from admm_tpu_torch.models._common import host64
        from admm_tpu_torch.models.covarianceselection import covarianceselection
        from admm_tpu_torch.models.sdp import random_sdp_instance
        from admm_tpu_torch.parallel import consensus_covsel, make_mesh, sdp_sharded
        cfg = ADMMConfig(maxiters=2000, abstol=1e-8, reltol=1e-8)
        rng = np.random.default_rng(0)
        g4 = make_mesh(4, group=mesh.group)
        C, A, b, Xstar, _, _ = random_sdp_instance(8, 8, 3, rng)
        t = lambda a: torch.as_tensor(a)
        sh = sdp_sharded(t(C), t(A), t(b), config=cfg, mesh=g4)
        ser = sdp(t(C), t(A), t(b), config=cfg)
        Z = host64(sh.zopt)
        assert np.isfinite(Z).all()
        assert np.abs(Z - host64(ser.zopt)).max() < 1e-8
        assert int(sh.steps) == int(ser.steps)
        D = rng.standard_normal((64, 8))
        con = consensus_covsel(D, 0.1, cfg, mesh=g4)
        ser_cv = covarianceselection(t(D), 0.1, cfg)
        Zc = host64(con.zopt)
        assert np.isfinite(Zc).all()
        assert np.abs(Zc - host64(ser_cv.zopt)).max() < 1e-2
        save(sdp_steps=sh.steps, sdp_pnorm=sh.hist["pnorm"], sdp_z=sh.zopt,
             cv_steps=con.steps, cv_pnorm=con.hist["pnorm"], cv_z=con.zopt)
    ''', tmp_path)
    check(*got)
    same_on_every_rank(got[3])


def test_ranks_that_stop_apart_fail_instead_of_hanging(tmp_path):
    """A rank that issues one collective fewer than the other: the other's
    collective fails at the group's timeout (here 60 s, inside the
    subprocess bound) and the run fails; it does not hang."""
    rc, initialized, output, _ = run_ranks('''
        import datetime
        import torch.distributed as dist
        # A short-timeout group of the same two ranks.
        g = dist.new_group([0, 1], timeout=datetime.timedelta(seconds=3))
        x = torch.ones(4)
        if rank == 0:
            dist.all_reduce(x, group=g)   # rank 1 never joins this one
    ''', tmp_path, timeout=60)
    assert initialized and rc != 0, output[-2000:]
