"""The functional runner of the port (``engine.make_admm_runner``) against
``admm`` and against admm_tpu's runner, one instance and lanes: the case of
tests/test_engine_features.py::test_vmap_batched_instances (per-lane
operators through admm_tpu's ``jax.vmap`` of the runner, through the port's
``lanes=True``), what lanes refuse, and K4's custom op, whose vmap rule
folds the lanes into the kernel's batch axis (on the CPU the op runs the
plain version, so the rule is checked here bit for bit).  f64; bars as
stated per test."""

import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from admm_tpu import ADMMConfig as JaxConfig
from admm_tpu.engine import make_admm_runner as jax_runner
from admm_tpu.ops.solve import SymShiftSolver as JaxShift
from admm_tpu_torch import ADMMConfig, Hooks, admm, make_admm_runner
from admm_tpu_torch.models.totalvariation import tv_system
from admm_tpu_torch.ops import tridiag
from admm_tpu_torch.ops.solve import SymShiftSolver

torch.set_num_threads(1)


def _model(seed=0, B=4, m=48, n=24):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((B, m, n)), rng.standard_normal((B, m, n)),
            rng.standard_normal((B, m)), rng.standard_normal((B, m)))


def _model_proxes(P, Q, r, s):
    sP = SymShiftSolver.from_matrix(torch.from_numpy(P.T @ P))
    sQ = SymShiftSolver.from_matrix(torch.from_numpy(Q.T @ Q))
    Ptr, Qts = torch.from_numpy(P.T @ r), torch.from_numpy(Q.T @ s)
    pf = lambda x, z, u, rho: sP.solve(Ptr + rho * (z - u), rho)  # noqa: E731
    pg = lambda x, z, u, rho: sQ.solve(Qts + rho * (x + u), rho)  # noqa: E731
    return pf, pg


@pytest.mark.parametrize("opts", [{}, {"unroll": 4, "objevals": True},
                                  {"fast": True, "fasttype": "weak", "maxiters": 300}])
def test_runner_matches_admm(opts):
    # One instance: the runner's raw outputs are admm's results bit for bit.
    Ps, Qs, rs, ss = _model()
    pf, pg = _model_proxes(Ps[0], Qs[0], rs[0], ss[0])
    cfg = ADMMConfig(**{"maxiters": 2000, **opts})
    obj = lambda x, z: torch.sum(x * x)  # noqa: E731
    zeros = torch.zeros(24, dtype=torch.float64)
    out = make_admm_runner(pf, pg, cfg, 1.0, -1.0, Hooks(obj=obj))(zeros, zeros, zeros, 0.0)
    res = admm(pf, pg, cfg, nA=24, nB=24, hooks=Hooks(obj=obj), dtype=torch.float64,
               device="cpu")
    assert int(out["steps"]) == res.steps and bool(out["diverged"]) == res.diverged
    assert torch.equal(out["xopt"], res.xopt) and torch.equal(out["uopt"], res.uopt)
    assert float(out["objopt"]) == res.objopt
    for name, trace in res.hist.items():
        assert torch.equal(out["hist"][name].nan_to_num(), trace.nan_to_num())


def test_runner_matches_jax_runner():
    # The same instance through admm_tpu's runner: steps equal, x to rtol 1e-9.
    Ps, Qs, rs, ss = _model(seed=1)
    P, Q, r, s = Ps[0], Qs[0], rs[0], ss[0]
    cfg = dict(maxiters=3000)
    pf, pg = _model_proxes(P, Q, r, s)
    zeros = torch.zeros(24, dtype=torch.float64)
    out = make_admm_runner(pf, pg, ADMMConfig(**cfg), 1.0, -1.0)(zeros, zeros, zeros, zeros)
    jP, jQ = JaxShift.from_matrix(jnp.asarray(P.T @ P)), JaxShift.from_matrix(jnp.asarray(Q.T @ Q))
    jPtr, jQts = jnp.asarray(P.T @ r), jnp.asarray(Q.T @ s)
    jrun = jax_runner(lambda x, z, u, rho: jP.solve(jPtr + rho * (z - u), rho),
                      lambda x, z, u, rho: jQ.solve(jQts + rho * (x + u), rho),
                      JaxConfig(**cfg), 1.0, -1.0)
    jz = jnp.zeros(24)
    jout = jrun(jz, jz, jz, jz)
    assert int(out["steps"]) == int(jout["steps"])
    ref = np.asarray(jout["xopt"])
    np.testing.assert_allclose(out["xopt"].numpy(), ref, rtol=1e-9, atol=1e-9 * np.abs(ref).max())


def _lane_prox_f(x, z, u, rho, d):
    return d["VP"] @ ((d["VP"].T @ (d["Ptr"] + rho * (z - u))) / (d["wP"] + rho))


def _lane_prox_g(x, z, u, rho, d):
    return d["VQ"] @ ((d["VQ"].T @ (d["Qts"] + rho * (x + u))) / (d["wQ"] + rho))


def test_lanes_with_per_lane_operators_match_jax_vmap():
    # tests/test_engine_features.py::test_vmap_batched_instances: B = 4
    # model problems, each with its own P and Q.  admm_tpu vmaps a function
    # that builds each lane's solvers and runner; the port stacks the lanes'
    # eigenbases as mapped data of one lanes=True runner.  Steps equal per
    # lane, x to rtol 1e-9, each lane within 1e-2 of its exact solution, and
    # each lane is the port's one-instance run (rtol 1e-9).
    Ps, Qs, rs, ss = _model()
    cfg = dict(maxiters=3000)

    def solve_one(P, Q, r, s):
        sP, sQ = JaxShift.from_matrix(P.T @ P), JaxShift.from_matrix(Q.T @ Q)
        Ptr, Qts = P.T @ r, Q.T @ s
        run = jax_runner(lambda x, z, u, rho: sP.solve(Ptr + rho * (z - u), rho),
                         lambda x, z, u, rho: sQ.solve(Qts + rho * (x + u), rho),
                         JaxConfig(**cfg), 1.0, -1.0)
        zz = jnp.zeros(24)
        out = run(zz, zz, zz, zz)
        return out["xopt"], out["steps"]

    jxs, jsteps = jax.jit(jax.vmap(solve_one))(Ps, Qs, rs, ss)

    t = torch.from_numpy
    wP, VP = torch.linalg.eigh(t(np.einsum("bmi,bmj->bij", Ps, Ps)))
    wQ, VQ = torch.linalg.eigh(t(np.einsum("bmi,bmj->bij", Qs, Qs)))
    data = {"VP": VP, "wP": wP, "VQ": VQ, "wQ": wQ,
            "Ptr": t(np.einsum("bmi,bm->bi", Ps, rs)), "Qts": t(np.einsum("bmi,bm->bi", Qs, ss))}
    run = make_admm_runner(_lane_prox_f, _lane_prox_g, ADMMConfig(**cfg), 1.0, -1.0,
                           has_data=True, lanes=True, mapped=set(data))
    zeros = torch.zeros(4, 24, dtype=torch.float64)
    out = run(zeros, zeros, zeros, zeros, data)
    assert out["steps"].tolist() == np.asarray(jsteps).tolist()
    assert len(set(out["steps"].tolist())) > 1  # the lanes stop apart
    np.testing.assert_allclose(out["xopt"].numpy(), np.asarray(jxs), rtol=1e-9,
                               atol=1e-9 * np.abs(np.asarray(jxs)).max())
    for b in range(4):
        truex = np.linalg.solve(Ps[b].T @ Ps[b] + Qs[b].T @ Qs[b],
                                Ps[b].T @ rs[b] + Qs[b].T @ ss[b])
        assert np.linalg.norm(out["xopt"][b].numpy() - truex) < 1e-2
        one = make_admm_runner(_lane_prox_f, _lane_prox_g, ADMMConfig(**cfg), 1.0, -1.0,
                               has_data=True)
        solo = one(zeros[0], zeros[0], zeros[0], zeros[0], {k: v[b] for k, v in data.items()})
        assert int(solo["steps"]) == int(out["steps"][b])
        np.testing.assert_allclose(out["xopt"][b].numpy(), solo["xopt"].numpy(), rtol=1e-9,
                                   atol=1e-9 * float(solo["xopt"].abs().max()))
        # A lane that stopped early wrote nothing past its steps.
        assert out["hist"]["pnorm"][b, int(out["steps"][b]):].isnan().all()


def test_lanes_refuse_what_they_do_not_run(capsys):
    # hooks.fused_zu runs on one instance only; quiet=False runs and prints
    # admm_tpu's vmapped rows (tests/test_torch_batch.py holds them).
    from admm_tpu_torch.ops.kernels import fused_soft_threshold_dual

    pf = lambda x, z, u, rho: z - u  # noqa: E731
    pg = lambda x, z, u, rho: x + u  # noqa: E731
    zeros = torch.zeros(2, 4, dtype=torch.float64)
    fused = Hooks(fused_zu=lambda x, u, rho: fused_soft_threshold_dual(x, u, 0.1 / rho))
    with pytest.raises(NotImplementedError, match="fused_zu"):
        make_admm_runner(pf, pg, ADMMConfig(maxiters=5), 1.0, -1.0, fused,
                         lanes=True)(zeros, zeros, zeros, zeros)
    out = make_admm_runner(pf, pg, ADMMConfig(maxiters=5, quiet=False), 1.0, -1.0,
                           lanes=True)(zeros, zeros, zeros, zeros)
    rows = capsys.readouterr().out.splitlines()
    assert out["steps"].tolist() == [1, 1] and rows == [
        "1\tpnorm 0.0000e+00\tperr 2.0000e-05\tdnorm 0.0000e+00\tderr 2.0000e-05"] * 2


@pytest.mark.parametrize("cutoff", [None, 63])
def test_cr_solve_op_vmap_rule_folds_lanes_bit_for_bit(cutoff):
    # K4's custom op under torch.func.vmap: lanes of (1, N) right-hand sides
    # (and of (2, N) ones) fold into one (lanes * rows, N) call, which on the
    # CPU is the plain version: the same bits as a direct call, and no
    # fallback of vmap to a lane loop.
    sol = tridiag.CyclicReductionSolver.from_tridiag(*tv_system(300, 2.0), dense_cutoff=cutoff)
    N = sol.alphas.shape[1]
    bb = torch.from_numpy(np.random.default_rng(3).standard_normal((6, N)))
    tridiag._LIVE[id(sol)] = sol
    op = torch.ops.admm_tpu_torch.cr_solve
    direct = op(bb, id(sol))
    assert torch.equal(direct, tridiag._cr_solve_torch(bb, sol))
    with warnings.catch_warnings(record=True) as seen:
        warnings.simplefilter("always")
        one = torch.func.vmap(lambda b: op(b[None], id(sol))[0])(bb)
        two = torch.func.vmap(lambda b: op(b, id(sol)), in_dims=1, out_dims=1)(
            bb.reshape(3, 2, N).transpose(0, 1))
    assert not [w for w in seen if "batching rule" in str(w.message)]
    assert torch.equal(one, direct)
    assert torch.equal(two.transpose(0, 1).reshape(6, N), direct)


def test_lanes_loop_under_the_config_precision_and_setup_at_full():
    # admm_tpu's _highest_precision_setup: the batch entry points set up
    # with float32 matmuls at full precision, and the runner's loop runs
    # under config.matmul_precision ('default' is torch's 'medium').
    from admm_tpu_torch.config import matmul_precision
    from admm_tpu_torch.models.paths import highest_precision_setup

    seen = []

    def pf(x, z, u, rho, d):
        seen.append(torch.get_float32_matmul_precision())
        return z - u

    run = make_admm_runner(pf, lambda x, z, u, rho, d: x + u,
                           ADMMConfig(maxiters=2, domaxiters=True, matmul_precision="default"),
                           1.0, -1.0, has_data=True, lanes=True)
    z = torch.zeros(2, 3, dtype=torch.float64)
    with matmul_precision("high"):
        run(z, z, z, z, {})
        setup = highest_precision_setup(torch.get_float32_matmul_precision)()
        assert torch.get_float32_matmul_precision() == "high"
    assert set(seen) == {"medium"} and setup == "highest"
