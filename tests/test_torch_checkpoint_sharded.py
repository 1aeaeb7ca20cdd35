"""Sharded checkpoints of the port (``utils.save_state_orbax``,
``load_state_orbax``, a format of the port's own): the twins of
tests/test_checkpoint.py's three orbax tests, each loaded field held
against what admm_tpu's ``load_state_orbax`` returns for the same solve
(f64, 1e-9 of the largest entry; steps equal); and a checkpoint written
by two processes (each rank its block of the per-shard state) loaded in
one process and resumed on a stacked mesh, and loaded back over the two
ranks, each taking its block again."""

import numpy as np
import torch

import admm_tpu as J
import admm_tpu.parallel as JP
import admm_tpu_torch as T
import admm_tpu_torch.parallel as TP
from admm_tpu.utils import load_state_orbax as j_load
from admm_tpu.utils import save_state_orbax as j_save
from admm_tpu_torch.utils import load_state_orbax, save_state_orbax

from _torch_ranks import check, run_ranks

torch.set_num_threads(1)

CPU8 = TP.make_mesh(8, device="cpu")


def _close(a, b, rtol=1e-9):
    b = np.asarray(b, dtype=np.float64)
    np.testing.assert_allclose(np.asarray(a, dtype=np.float64), b, rtol=rtol,
                               atol=rtol * max(np.abs(b).max(), 1e-300))


def _same_fields(state, jstate):
    assert set(state) == set(jstate)
    for key in state:
        if key == "steps":
            assert np.asarray(state[key]).tolist() == np.asarray(jstate[key]).tolist()
        else:
            _close(state[key], jstate[key])


def test_orbax_roundtrip_with_sharded_consensus_state(tmp_path):
    rng = np.random.default_rng(1)
    D = rng.standard_normal((128, 16))
    s = rng.standard_normal(128)
    res = TP.consensus_lasso(D, s, 0.1, T.ADMMConfig(maxiters=200), mesh=CPU8)
    save_state_orbax(res, tmp_path / "consensus_ckpt")
    state = load_state_orbax(tmp_path / "consensus_ckpt")
    np.testing.assert_array_equal(state["x0"], res.xopt.numpy())
    np.testing.assert_array_equal(state["xi"], res.extra["xi"].numpy())
    np.testing.assert_array_equal(state["ui"], res.extra["ui"].numpy())
    assert state["steps"] == res.steps
    jres = JP.consensus_lasso(D, s, 0.1, J.ADMMConfig(maxiters=200))
    j_save(jres, tmp_path / "j")
    _same_fields(state, j_load(tmp_path / "j"))


def test_orbax_checkpoint_resumes_consensus_solve(tmp_path):
    rng = np.random.default_rng(2)
    D = rng.standard_normal((256, 24))
    s = rng.standard_normal(256)
    lam = 0.1
    obj = lambda x: 0.5 * np.sum((D @ x - s) ** 2) + lam * np.sum(np.abs(x))  # noqa: E731
    cold = TP.consensus_lasso(D, s, lam, T.ADMMConfig(maxiters=5000), mesh=CPU8)
    pre = TP.consensus_lasso(D, s, lam, T.ADMMConfig(maxiters=15, domaxiters=True), mesh=CPU8)
    save_state_orbax(pre, tmp_path / "partial")
    state = load_state_orbax(tmp_path / "partial")
    resumed = TP.consensus_lasso(D, s, lam, T.ADMMConfig(maxiters=5000), mesh=CPU8,
                                 xi0=state["xi"], ui0=state["ui"], z0=state["z0"])
    assert resumed.steps < cold.steps
    f_cold, f_res = obj(cold.zopt.numpy()), obj(resumed.zopt.numpy())
    assert abs(f_res - f_cold) <= 1e-3 * abs(f_cold)
    jpre = JP.consensus_lasso(D, s, lam, J.ADMMConfig(maxiters=15, domaxiters=True))
    j_save(jpre, tmp_path / "j")
    _same_fields(state, j_load(tmp_path / "j"))


def test_orbax_roundtrip_2d_batch_state(tmp_path):
    rng = np.random.default_rng(20)
    D = rng.standard_normal((48, 8))
    S = rng.standard_normal((4, 48))
    cfg = T.ADMMConfig(maxiters=400)
    full = TP.consensus_lasso_batch(D, S, 0.2, cfg, mesh=TP.make_mesh2d(2, 2, device="cpu"))
    save_state_orbax(full, tmp_path / "ckpt2d")
    state = load_state_orbax(tmp_path / "ckpt2d")
    np.testing.assert_array_equal(state["steps"], full.steps.numpy())
    np.testing.assert_array_equal(state["xi"], full.extra["xi"].numpy())
    np.testing.assert_array_equal(state["ui"], full.extra["ui"].numpy())
    # Resume from the saved per-lane state: a few polish steps at most.
    again = TP.consensus_lasso_batch(D, S, 0.2, cfg, mesh=TP.make_mesh2d(2, 2, device="cpu"),
                                     xi0=state["xi"], ui0=state["ui"], z0=state["z0"])
    assert int(again.steps.max()) <= 3
    jfull = JP.consensus_lasso_batch(D, S, 0.2, J.ADMMConfig(maxiters=400),
                                     mesh=JP.make_mesh2d(2, 2))
    j_save(jfull, tmp_path / "j")
    _same_fields(state, j_load(tmp_path / "j"))


def test_checkpoint_written_by_two_ranks_resumes_anywhere(tmp_path):
    """Two ranks save one consensus solve (4 shards each): the blocks
    concatenate to the stacked solve's per-shard state in one process
    (1e-9), resume there, and load back over the two ranks, each taking
    its block again to resume to the stacked resumption's steps."""
    rng = np.random.default_rng(2)
    D, s = rng.standard_normal((256, 24)), rng.standard_normal(256)
    ckpt = tmp_path / "ckpt"
    code = f'''
        from admm_tpu_torch import ADMMConfig
        from admm_tpu_torch.parallel import consensus_lasso, make_mesh
        from admm_tpu_torch.utils import load_state_orbax, save_state_orbax
        rng = np.random.default_rng(2)
        D, s = rng.standard_normal((256, 24)), rng.standard_normal(256)
        g8 = make_mesh(8, group=mesh.group)
        pre = consensus_lasso(D, s, 0.1, ADMMConfig(maxiters=15, domaxiters=True), mesh=g8)
        save_state_orbax(pre, {str(ckpt)!r})
        st = load_state_orbax({str(ckpt)!r})
        res = consensus_lasso(D, s, 0.1, ADMMConfig(maxiters=5000), mesh=g8, xi0=st["xi"],
                              ui0=st["ui"], z0=st["z0"])
        save(steps=res.steps, zopt=res.zopt)
    '''
    rc, init, out, got = run_ranks(code, tmp_path)
    check(rc, init, out)
    assert sorted(p.name for p in ckpt.iterdir()) == ["block-0.npz", "block-1.npz",
                                                      "state.npz"]
    state = load_state_orbax(ckpt)
    pre = TP.consensus_lasso(D, s, 0.1, T.ADMMConfig(maxiters=15, domaxiters=True), mesh=CPU8)
    _close(state["xi"], pre.extra["xi"].numpy())
    _close(state["ui"], pre.extra["ui"].numpy())
    assert state["steps"] == 15
    resumed = TP.consensus_lasso(D, s, 0.1, T.ADMMConfig(maxiters=5000), mesh=CPU8,
                                 xi0=state["xi"], ui0=state["ui"], z0=state["z0"])
    for r in got:
        assert int(r["steps"]) == resumed.steps
        _close(r["zopt"], resumed.zopt.numpy())
