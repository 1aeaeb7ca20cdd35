"""The port on a CUDA device: the Triton z/u kernel and the CUDA C++
cyclic-reduction kernel against their plain PyTorch versions, and the
LASSO and TV slices going through them.

Every case needs a CUDA device and skips without one.  This file imports
no JAX, so it also runs where JAX is not installed; skip the repo's
conftest (which imports JAX) there:

    python -m pytest tests/test_torch_gpu.py -m gpu --noconftest -p no:cacheprovider
"""

import numpy as np
import pytest
import torch

from admm_tpu_torch import ADMMConfig, lasso, totalvariation
from admm_tpu_torch.models.totalvariation import tv_system
from admm_tpu_torch.ops.kernels import _fused_torch, fused_soft_threshold_dual
from admm_tpu_torch.ops.tridiag import CyclicReductionSolver, _cr_solve_torch, cr_solve

torch.set_num_threads(1)
pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.fixture
def launches(monkeypatch):
    monkeypatch.setattr(fused_soft_threshold_dual, "launches", 0)
    return lambda: fused_soft_threshold_dual.launches


def _vectors(n, dev, dtype, seed=2):
    rng = np.random.default_rng(seed)
    return (torch.from_numpy(rng.standard_normal(n)).to(dev, dtype),
            torch.from_numpy(rng.standard_normal(n)).to(dev, dtype))


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("n", [1, 64, 1000, 5000, 8192, 70000])
def test_triton_kernel_matches_twin(cuda, launches, n, dtype):
    x, u = _vectors(n, cuda, dtype)
    t = torch.tensor(0.37, dtype=dtype, device=cuda)
    u_before = u.clone()
    z_k, u_k = fused_soft_threshold_dual(x, u, t)
    torch.cuda.synchronize()
    assert launches() == 1
    z_t, u_t = _fused_torch(x, u, t)
    # Same rounding by construction (triton_fused_zu.py docstring): exact.
    assert torch.equal(z_k, z_t) and torch.equal(u_k, u_t)
    assert torch.equal(u, u_before)  # out of place


def test_triton_kernel_edge_values(cuda):
    # Exactly at the threshold, signed zeros, infinities and NaN.
    t = torch.tensor(0.5, dtype=torch.float32, device=cuda)
    x = torch.tensor([0.25, -0.25, 0.0, -0.0, float("inf"), float("-inf"),
                      float("nan"), 1.0], device=cuda)
    u = torch.tensor([0.25, -0.25, 0.0, 0.0, 0.0, 0.0, 0.0, -2.0], device=cuda)
    z_k, u_k = fused_soft_threshold_dual(x, u, t)
    z_t, u_t = _fused_torch(x, u, t)
    # NaN where the plain version has NaN, equal values elsewhere.
    for k, ref in ((z_k, z_t), (u_k, u_t)):
        nan = torch.isnan(ref)
        assert torch.equal(torch.isnan(k), nan)
        assert torch.equal(k[~nan], ref[~nan])


def test_wrapper_refuses_what_the_kernel_does_not_take(cuda):
    x, u = _vectors(16, cuda, torch.float32)
    with pytest.raises(TypeError, match="0-d tensor"):
        fused_soft_threshold_dual(x, u, 0.3)
    with pytest.raises(ValueError, match="u is"):
        fused_soft_threshold_dual(x, u.double(), torch.tensor(0.3, device=cuda))
    with pytest.raises(TypeError, match="dtype"):
        h = x.half()
        fused_soft_threshold_dual(h, h, torch.tensor(0.3, device=cuda).half())


def test_lasso_on_gpu_goes_through_the_kernel(cuda, launches):
    rng = np.random.default_rng(2)
    D = rng.standard_normal((64, 128))
    D = D / np.sqrt(np.sum(D**2, axis=0, keepdims=True))
    s = D @ (rng.standard_normal(128) * (rng.random(128) < 0.6))
    lam = 0.1 * np.max(np.abs(D.T @ s))
    cfg = ADMMConfig(maxiters=47, domaxiters=True, unroll=4)
    res = lasso(D, s, lam, cfg, use_fused_kernel=True, device=cuda)
    assert res.steps == 47 and res.xopt.device.type == "cuda"
    # 12 chunks of 4 sub-steps: frozen sub-steps run the kernel too.
    assert launches() == 48
    cpu = lasso(D, s, lam, cfg, use_fused_kernel=True, device="cpu")
    # f64 on both devices; cuBLAS and the CPU BLAS sum in other orders.
    np.testing.assert_allclose(res.xopt.cpu().numpy(), cpu.xopt.numpy(),
                               rtol=1e-9, atol=1e-10)
    plain = lasso(D, s, lam, cfg, use_fused_kernel=False, device=cuda)
    assert launches() == 48
    np.testing.assert_allclose(plain.xopt.cpu().numpy(), cpu.xopt.numpy(),
                               rtol=1e-9, atol=1e-10)


def _tv_system(n, rho=1.0):
    return tv_system(n, rho)


def _random_system(n, seed=6):
    rng = np.random.default_rng(seed)
    return (np.r_[0.0, rng.standard_normal(n - 1)], 4.0 + np.abs(rng.standard_normal(n)),
            np.r_[rng.standard_normal(n - 1), 0.0])


@pytest.fixture
def cr_launches(monkeypatch):
    monkeypatch.setattr(cr_solve, "launches", 0)
    return lambda: cr_solve.launches


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("lanes,n,cutoff,system", [
    (1, 1, None, _tv_system),
    (1, 2, None, _tv_system),
    (1, 7, None, _random_system),
    (3, 1000, None, _tv_system),
    (8, 8192, None, _random_system),
    (2, 5000, 63, _random_system),
    (1, 300, 1023, _tv_system),
    (4, 20000, 1023, _tv_system),
])
def test_cr_kernel_matches_plain_version(cuda, cr_launches, dtype, lanes, n, cutoff, system):
    sol = CyclicReductionSolver.from_tridiag(*system(n), dense_cutoff=cutoff,
                                             device=cuda, dtype=dtype)
    N = sol.alphas.shape[1]
    rng = np.random.default_rng(n)
    bb = torch.zeros((lanes, N), dtype=dtype, device=cuda)
    bb[:, :n] = torch.from_numpy(rng.standard_normal((lanes, n))).to(cuda, dtype)
    before = bb.clone()
    x = cr_solve(bb, sol)
    torch.cuda.synchronize()
    assert cr_launches() == 1
    assert torch.equal(bb, before)  # the input is not modified
    # Same rounding by construction (csrc/cr_solve.cu), and the dense
    # tail is the same torch.matmul call on the same contiguous operand.
    assert torch.equal(x, _cr_solve_torch(bb, sol))
    assert torch.isfinite(x).all()


def test_cr_kernel_solves_the_system(cuda):
    n = 4097
    args = _random_system(n)
    sol = CyclicReductionSolver.from_tridiag(*args, device=cuda)
    b = np.random.default_rng(1).standard_normal(n)
    x = sol.solve(torch.from_numpy(b).to(cuda)).cpu().numpy()
    T = np.diag(args[1]) + np.diag(args[0][1:], -1) + np.diag(args[2][:-1], 1)
    np.testing.assert_allclose(x, np.linalg.solve(T, b), atol=1e-9)


def test_cr_wrapper_refuses_what_the_kernel_does_not_take(cuda):
    sol = CyclicReductionSolver.from_tridiag(*_tv_system(100), device=cuda,
                                             dtype=torch.float32)
    N = sol.alphas.shape[1]
    wide = torch.zeros((2, 2 * N), device=cuda)
    with pytest.raises(ValueError, match="contiguous"):
        cr_solve(wide[:, ::2], sol)
    with pytest.raises(ValueError, match="solver's stacks"):
        cr_solve(torch.zeros((1, N)), sol)  # CPU rhs, CUDA solver
    with pytest.raises(ValueError, match="solver's stacks"):
        cr_solve(torch.zeros((1, N), dtype=torch.float64, device=cuda), sol)
    half = CyclicReductionSolver.from_tridiag(*_tv_system(100), device=cuda,
                                              dtype=torch.float16)
    with pytest.raises(TypeError, match="dtype"):
        cr_solve(torch.zeros((1, N), dtype=torch.float16, device=cuda), half)


@pytest.mark.parametrize("n,solver", [(3000, "cr_masked"), (20000, "cr")])
def test_totalvariation_on_gpu_goes_through_the_kernel(cuda, cr_launches, n, solver):
    rng = np.random.default_rng(3)
    sig = np.repeat(rng.standard_normal(n // 64 + 1), 64)[:n] + 0.5 * rng.standard_normal(n)
    cfg = ADMMConfig(maxiters=41, domaxiters=True, unroll=4)
    res = totalvariation(sig, 0.5, cfg, solver=solver, device=cuda)
    assert res.steps == 41 and res.xopt.device.type == "cuda"
    # 11 chunks of 4 sub-steps: frozen sub-steps solve too.
    assert cr_launches() == 44
    plain = totalvariation(sig, 0.5, cfg, solver=solver, device=cuda, _plain_cr=True)
    assert cr_launches() == 44
    assert torch.equal(res.xopt, plain.xopt)
    cpu = totalvariation(sig, 0.5, cfg, solver=solver, device="cpu")
    # f64 on both devices; the elementwise steps round alike, the norms
    # and the dense tail sum in other orders.
    np.testing.assert_allclose(res.xopt.cpu().numpy(), cpu.xopt.numpy(),
                               rtol=1e-9, atol=1e-10)
