"""K4's gradient rules and the TV hypergradient of the port.

The custom op ``admm_tpu_torch::cr_solve`` with its rules
(``ops/tridiag.cr_solve_op``): on CPU tensors its body is the plain
version, so these tests reach the same backward, forward-mode and vmap
rules that launch the kernel on the card.  Then the TV hypergradient
through ``models/totalvariation.make_prox_ops(solver='cr')`` against
admm_tpu's in f64 (d/dlam and d/ds to rtol 1e-8), through the op's rules
against the plain path, on lanes against the serial solve, and the
port's ``hypergradient_tuning`` against admm_tpu's example.  f64.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from admm_tpu import ADMMConfig as JConfig
from admm_tpu.diff import make_implicit_solver as jax_solver
from admm_tpu.linop import DiffOp as JDiffOp
from admm_tpu.models.totalvariation import make_prox_ops as jax_tv_ops
from admm_tpu.ops.tridiag import CyclicReductionSolver as JCR
from admm_tpu_torch import ADMMConfig, make_implicit_batch_solver, make_implicit_solver
from admm_tpu_torch.linop import DiffOp
from admm_tpu_torch.models.totalvariation import make_prox_ops, tv_system
from admm_tpu_torch.ops import tridiag
from admm_tpu_torch.ops.tridiag import CyclicReductionSolver, cr_solve_op

torch.set_num_threads(1)
T64 = torch.float64


def _random_system(n, seed=9):
    """chip_smoke.py's non-symmetric diagonally dominant tridiagonal."""
    rng = np.random.default_rng(seed)
    return (np.r_[0.0, rng.standard_normal(n - 1)], 4.0 + np.abs(rng.standard_normal(n)),
            np.r_[rng.standard_normal(n - 1), 0.0])


def _tv(n):
    return tv_system(n, 1.0)


def _dense(system, N):
    dl, d, du = system
    n = d.shape[0]
    T = np.eye(N)
    T[:n, :n] = np.diag(d) + np.diag(dl[1:], -1) + np.diag(du[:-1], 1)
    return T


@pytest.fixture
def op_calls(monkeypatch):
    """Counts the op's bodies: on the CPU each runs ``_cr_solve_torch`` once."""
    calls = []
    plain = tridiag._cr_solve_torch

    def counted(bb, sol):
        calls.append(tuple(bb.shape))
        return plain(bb, sol)

    monkeypatch.setattr(tridiag, "_cr_solve_torch", counted)
    return calls


@pytest.mark.parametrize("system", [_tv, _random_system])
@pytest.mark.parametrize("n, cutoff", [(50, None), (50, 7), (200, 15)])
def test_op_passes_gradcheck_with_forward_ad(system, n, cutoff):
    sol = CyclicReductionSolver.from_tridiag(*system(n), dense_cutoff=cutoff)
    bb = torch.from_numpy(np.random.default_rng(n).standard_normal((3, sol.alphas.shape[1])))
    assert torch.autograd.gradcheck(lambda b: cr_solve_op(b, sol), (bb.requires_grad_(),),
                                    check_forward_ad=True, check_backward_ad=True)


@pytest.mark.parametrize("system", [_tv, _random_system])
def test_op_backward_solves_the_transposed_system(system):
    n = 60
    sol = CyclicReductionSolver.from_tridiag(*system(n), dense_cutoff=7)
    N = sol.alphas.shape[1]
    rng = np.random.default_rng(1)
    bb, g = (torch.from_numpy(rng.standard_normal((2, N))) for _ in range(2))
    _, pull = torch.func.vjp(lambda b: cr_solve_op(b, sol), bb)
    T = _dense(system(n), N)
    np.testing.assert_allclose(pull(g)[0].numpy(), np.linalg.solve(T.T, g.numpy().T).T,
                               rtol=1e-12, atol=1e-13)
    # TV's bands are each other's transpose: its backward reuses the solver.
    assert (sol.transposed() is sol) == (system is _tv)
    assert sol.transposed() is sol.transposed()  # built once and kept


@pytest.mark.parametrize("system", [_tv, _random_system])
def test_op_tangent_is_a_solve_and_never_zero(system):
    # A tangent through the op comes back as T^-1 b', not as zeros (what a
    # custom op without a forward-mode rule can silently return).
    sol = CyclicReductionSolver.from_tridiag(*system(40))
    N = sol.alphas.shape[1]
    rng = np.random.default_rng(2)
    bb, bdot = (torch.from_numpy(rng.standard_normal((2, N))) for _ in range(2))
    _, tangent = torch.func.jvp(lambda b: cr_solve_op(b, sol), (bb,), (bdot,))
    assert float(tangent.abs().max()) > 0.1
    assert torch.equal(tangent, tridiag._cr_solve_torch(bdot, sol))
    import torch.autograd.forward_ad as fwAD
    with fwAD.dual_level():
        out = cr_solve_op(fwAD.make_dual(bb, bdot), sol)
        assert torch.equal(fwAD.unpack_dual(out).tangent, tangent)


@pytest.mark.parametrize("cutoff", [None, 7])
def test_vmap_of_vjp_is_one_solve_and_equals_per_lane_vjps(op_calls, cutoff):
    sol = CyclicReductionSolver.from_tridiag(*_random_system(50), dense_cutoff=cutoff)
    N = sol.alphas.shape[1]
    rng = np.random.default_rng(3)
    bb = torch.from_numpy(rng.standard_normal((2, N)))
    gs = torch.from_numpy(rng.standard_normal((5, 2, N)))
    _, pull = torch.func.vjp(lambda b: cr_solve_op(b, sol), bb)
    op_calls.clear()
    lanes = torch.func.vmap(pull)(gs)[0]
    assert op_calls == [(10, N)]   # the 5 lanes' backward: one (lanes * B, N) solve
    per = torch.stack([pull(gs[i])[0] for i in range(5)])
    np.testing.assert_allclose(lanes.numpy(), per.numpy(), rtol=0, atol=1e-14)
    if cutoff is None:
        assert torch.equal(lanes, per)


# ---- the TV hypergradient -------------------------------------------------

_KW = dict(rho=1.0, maxiters=3000, abstol=1e-12, reltol=1e-12, quiet=True)


def _signal(n, seed=0):
    rng = np.random.default_rng(seed)
    truth = np.repeat(rng.standard_normal(max(n // 64, 1)), 64)[:n]
    truth = np.r_[truth, np.zeros(n - truth.size)]
    return truth, truth + 0.5 * rng.standard_normal(n)


def _port_tv(s, lam, cutoff):
    pf, pg, _, data, _ = make_prox_ops(torch.from_numpy(s), lam, ADMMConfig(**_KW), solver="cr")
    if cutoff is not None:
        data["cr"] = CyclicReductionSolver.from_tridiag(*tv_system(s.size, 1.0),
                                                        dense_cutoff=cutoff)
    n = s.size
    return make_implicit_solver(pf, pg, ADMMConfig(**_KW), A=DiffOp(n), nA=n, nB=n), data


def _jax_grads(s, truth, lam, cutoff):
    jcfg = JConfig(**_KW)
    pf, pg, _, data, _ = jax_tv_ops(jnp.asarray(s), lam, jcfg, solver="cr")
    if cutoff is not None:
        data["cr"] = JCR.from_tridiag(*tv_system(s.size, 1.0), dense_cutoff=cutoff)
    n = s.size
    solve = jax_solver(pf, pg, jcfg, A=JDiffOp(n), nA=n, nB=n)
    jt = jnp.asarray(truth)

    def loss(lam_, s_):
        return jnp.mean((solve(dict(data, lam=lam_, s=s_))[0] - jt) ** 2)

    return jax.grad(loss, argnums=(0, 1))(jnp.asarray(lam), jnp.asarray(s))


def _port_grads(solve, data, truth):
    t = torch.from_numpy(truth)

    def loss(lam_, s_):
        return torch.mean((solve(dict(data, lam=lam_, s=s_))[0] - t) ** 2)

    return torch.func.grad(loss, argnums=(0, 1))(data["lam"], data["s"])


@pytest.mark.parametrize("cutoff", [None, 63])
def test_tv_hypergradient_matches_admm_tpu(cutoff):
    # n = 1023: one full level-set of the masked form, or the hybrid cut at
    # 63 (four masked levels, then the dense tail).
    truth, s = _signal(1023)
    solve, data = _port_tv(s, 0.5, cutoff)
    assert (data["cr"].Tinv is not None) == (cutoff is not None)
    g_lam, g_s = _port_grads(solve, data, truth)
    j_lam, j_s = _jax_grads(s, truth, 0.5, cutoff)
    np.testing.assert_allclose(float(g_lam), float(j_lam), rtol=1e-8)
    np.testing.assert_allclose(g_s.numpy(), np.asarray(j_s), rtol=1e-8,
                               atol=1e-8 * float(np.abs(np.asarray(j_s)).max()))


def test_tv_hypergradient_through_the_op_rules_equals_the_plain_path(monkeypatch, op_calls):
    # On the card, cr_solve is the op with its rules; on the CPU it is the
    # plain version, differentiated by autograd.  Route the CPU through the
    # op: the same gradient, and each adjoint step is one op solve.
    truth, s = _signal(1023, seed=1)
    solve, data = _port_tv(s, 0.5, 63)
    plain = _port_grads(solve, data, truth)
    monkeypatch.setattr(tridiag, "cr_solve", cr_solve_op)
    op_calls.clear()
    with torch.no_grad():
        solve(data)
    forward = len(op_calls)
    op_calls.clear()
    ruled = _port_grads(solve, data, truth)
    for a, b in zip(ruled, plain):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-10,
                                   atol=1e-12 * float(b.abs().max()))
    # The backward: one solve per application of J^T, one for the
    # linearization at w*, and two for the data VJP (its primal and its
    # pullback).
    assert len(op_calls) - forward == solve.stats["applies"] + 3


@pytest.mark.parametrize("method", ["neumann", "gmres"])
def test_tv_lanes_through_the_op_equal_the_serial_gradients(monkeypatch, op_calls, method):
    # tv_batch's setup (the hybrid form on lanes): per-lane d loss_i / d lam_i
    # through the batch solver equal the serial ones, and under the op each
    # Neumann adjoint step is one solve of all lanes.
    monkeypatch.setattr(tridiag, "cr_solve", cr_solve_op)
    n, B = 255, 3
    rng = np.random.default_rng(4)
    S = np.cumsum(rng.standard_normal((B, n)), axis=1)
    truth = np.zeros(n)
    lams = torch.tensor([0.5, 1.0, 2.0], dtype=T64)
    cfg = ADMMConfig(**_KW)
    pf, pg, _, data, _ = make_prox_ops(torch.from_numpy(S[0]), 1.0, cfg, solver="cr",
                                       batched=True)
    assert data["cr"].Tinv is not None
    kw = dict(A=DiffOp(n), nA=n, nB=n, vjp_method=method)
    batch = make_implicit_batch_solver(pf, pg, cfg, mapped={"s", "lam"}, **kw)
    serial = make_implicit_solver(pf, pg, cfg, **kw)
    St, t = torch.from_numpy(S), torch.from_numpy(truth)
    with torch.no_grad():
        batch(dict(data, s=St, lam=lams))
    forward = len(op_calls)
    op_calls.clear()
    g = torch.func.grad(lambda l: torch.sum(
        torch.mean((batch(dict(data, s=St, lam=l))[0] - t) ** 2, dim=1)))(lams)
    # Every solve of the backward takes all B lanes at once: one per
    # application of J^T, one for the linearization at w* and one for the
    # data VJP's primal (lam does not reach the solve, so no pullback).
    assert len(op_calls) - forward == batch.stats["applies"] + 2
    assert all(c[0] == B for c in op_calls)
    for i in range(B):
        gi = torch.func.grad(lambda li: torch.mean(
            (serial(dict(data, s=St[i], lam=li))[0] - t) ** 2))(lams[i])
        np.testing.assert_allclose(float(g[i]), float(gi), rtol=1e-9)


def test_vmap_of_grad_over_the_serial_tv_solve_is_one_solve_of_all_lanes(monkeypatch,
                                                                         op_calls):
    # torch.func.vmap(torch.func.grad(loss)) over the SERIAL solver at 4
    # values of lambda: the forward is one lanes runner and the backward
    # one lanes adjoint, so under the op every solve takes the 4 lanes at
    # once; each lane's gradient equals the serial one.
    monkeypatch.setattr(tridiag, "cr_solve", cr_solve_op)
    truth, s = _signal(255, seed=2)
    cfg = ADMMConfig(**_KW)
    pf, pg, _, data, _ = make_prox_ops(torch.from_numpy(s), 1.0, cfg, solver="cr",
                                       batched=True)
    serial = make_implicit_solver(pf, pg, cfg, A=DiffOp(255), nA=255, nB=255)
    t = torch.from_numpy(truth)
    lams = torch.tensor([0.25, 0.5, 1.0, 2.0], dtype=T64)

    def loss(lam):
        return torch.mean((serial(dict(data, lam=lam))[0] - t) ** 2)

    op_calls.clear()
    g = torch.func.vmap(torch.func.grad(loss))(lams)
    assert op_calls and all(c[0] == 4 for c in op_calls)
    adjoint = serial.stats["applies"]
    for i in range(4):
        gi = torch.func.grad(loss)(lams[i])
        np.testing.assert_allclose(float(g[i]), float(gi), rtol=1e-10)
    op_calls.clear()
    with torch.no_grad():
        torch.func.vmap(loss)(lams)
    forward = len(op_calls)
    op_calls.clear()
    torch.func.vmap(torch.func.grad(loss))(lams)
    # The backward: one solve of all lanes per application of J^T, one for
    # the linearization at w* and one for the data VJP's primal.
    assert len(op_calls) - forward == adjoint + 2


def test_hypergradient_tuning_matches_admm_tpu():
    from admm_tpu_torch.examples.hypergradient import hypergradient_tuning
    from examples.hypergradient import hypergradient_tuning as jax_tuning

    ours = hypergradient_tuning(n=80, steps=8, quiet=True, device="cpu")
    ref = jax_tuning(n=80, steps=8, quiet=True)
    np.testing.assert_allclose(np.array(ours), np.array(ref), rtol=1e-8)
    # The cyclic-reduction form (K4's x-prox on the card) learns the same lam.
    cr = hypergradient_tuning(n=80, steps=8, quiet=True, device="cpu", solver="cr")
    np.testing.assert_allclose(np.array(cr), np.array(ours), rtol=1e-8)
