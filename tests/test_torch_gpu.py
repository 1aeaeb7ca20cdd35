"""The port on a CUDA device: the CUDA C++ z/u kernel in both its modes
(K1, the z/u pass; K1b, the pass with the whole engine tail) and the
cyclic-reduction, GEMV-pair and resident-LASSO kernels against their
plain PyTorch versions, the LASSO, group-lasso and TV slices going
through them, and the engine variants (slice 2): one chunk of each on the
headline problem without a synchronising call inside its steps, and each
against the same solve on the CPU; and the families of slices 3 and 4
(basis pursuit, fused lasso, LAD, Huber, quantile, linear SVM) and of
slices 5 and 7 (the LP and QP on their KKT solvers, covariance selection
and the SDP), which run no kernel: one chunk of each without a
synchronising call inside it (the eigh paths' calls counted and
recorded), f32 against f64 on the card to
admm_tpu/benchmarks/matrix.py's f32 bars, and f64 on the card against the
CPU.

Every case needs a CUDA device and skips without one.  This file imports
no JAX, so it also runs where JAX is not installed; skip the repo's
conftest (which imports JAX) there:

    python -m pytest tests/test_torch_gpu.py -m gpu --noconftest -p no:cacheprovider
"""

import dataclasses
import importlib
import warnings

import numpy as np
import pytest
import torch

from admm_tpu_torch import (ADMMConfig, admm, basispursuit, covarianceselection, elasticnet,
                            fusedlasso, get_prox_ops, grouplasso, huberfit, lad, lasso,
                            linearprogram, linearsvm, model, nnls, quadraticprogram, quantile, sdp,
                            totalvariation, totalvariation2d)
from admm_tpu_torch.benchmarks.headline import make_problem
from admm_tpu_torch.experiments.gemv_pair_probe import make_operands
from admm_tpu_torch.models.sdp import random_sdp_instance
from admm_tpu_torch.models.totalvariation import tv_system
from admm_tpu_torch.ops.gemv_pair import (
    _gemv_pair_torch, _resident_lasso_torch, aligned_rows, gemv_pair, resident_lasso)
from admm_tpu_torch.ops.kernels import (
    _fused_torch, _fused_zu_tail_torch, fused_soft_threshold_dual, fused_zu_tail)
from admm_tpu_torch.ops.solve import FatShiftSolver
from admm_tpu_torch.ops.tridiag import CyclicReductionSolver, _cr_solve_torch, cr_solve

torch.set_num_threads(1)
pytestmark = pytest.mark.gpu
engine_mod = importlib.import_module("admm_tpu_torch.engine")


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.fixture
def launches(monkeypatch):
    monkeypatch.setattr(fused_soft_threshold_dual, "launches", 0)
    return lambda: fused_soft_threshold_dual.launches


@pytest.fixture
def tail_launches(monkeypatch):
    monkeypatch.setattr(fused_zu_tail, "launches", 0)
    return lambda: fused_zu_tail.launches


def _vectors(n, dev, dtype, seed=2):
    rng = np.random.default_rng(seed)
    return (torch.from_numpy(rng.standard_normal(n)).to(dev, dtype),
            torch.from_numpy(rng.standard_normal(n)).to(dev, dtype))


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("n", [1, 64, 1000, 5000, 8192, 70000])
def test_zu_mode_matches_twin(cuda, launches, n, dtype):
    x, u = _vectors(n, cuda, dtype)
    t = torch.tensor(0.37, dtype=dtype, device=cuda)
    u_before = u.clone()
    z_k, u_k = fused_soft_threshold_dual(x, u, t)
    torch.cuda.synchronize()
    assert launches() == 1
    z_t, u_t = _fused_torch(x, u, t)
    # Same rounding by construction (csrc/zu_tail.cu header): exact.
    assert torch.equal(z_k, z_t) and torch.equal(u_k, u_t)
    assert torch.equal(u, u_before)  # out of place


def test_zu_mode_edge_values(cuda):
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


def test_lasso_on_gpu_goes_through_the_kernel(cuda, launches, tail_launches):
    rng = np.random.default_rng(2)
    D = rng.standard_normal((64, 128))
    D = D / np.sqrt(np.sum(D**2, axis=0, keepdims=True))
    s = D @ (rng.standard_normal(128) * (rng.random(128) < 0.6))
    lam = 0.1 * np.max(np.abs(D.T @ s))
    cfg = ADMMConfig(maxiters=47, domaxiters=True, unroll=4)
    res = lasso(D, s, lam, cfg, use_fused_kernel=True, device=cuda)
    assert res.steps == 47 and res.xopt.device.type == "cuda"
    # 12 chunks of 4 sub-steps, each one launch of K1b (the tail mode):
    # frozen sub-steps run the kernel too.
    assert tail_launches() == 48 and launches() == 0
    cpu = lasso(D, s, lam, cfg, use_fused_kernel=True, device="cpu")
    # f64 on both devices; cuBLAS and the CPU BLAS sum in other orders.
    np.testing.assert_allclose(res.xopt.cpu().numpy(), cpu.xopt.numpy(),
                               rtol=1e-9, atol=1e-10)
    for name in ("pnorm", "dnorm", "perr", "derr"):
        np.testing.assert_allclose(res.trace(name), cpu.trace(name), rtol=1e-9)
    plain = lasso(D, s, lam, cfg, use_fused_kernel=False, device=cuda)
    assert tail_launches() == 48
    np.testing.assert_allclose(plain.xopt.cpu().numpy(), cpu.xopt.numpy(),
                               rtol=1e-9, atol=1e-10)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_converging_lasso_on_gpu_stops_with_the_plain_tail(cuda, tail_launches, dtype):
    rng = np.random.default_rng(5)
    D = rng.standard_normal((96, 300))
    D = D / np.sqrt(np.sum(D**2, axis=0, keepdims=True))
    s = D @ (rng.standard_normal(300) * (rng.random(300) < 0.2))
    lam = 0.1 * np.max(np.abs(D.T @ s))
    cfg = ADMMConfig(maxiters=3000, unroll=8)
    D_t, s_t = (torch.from_numpy(a).to(cuda, dtype) for a in (D, s))
    res = lasso(D_t, s_t, lam, cfg, use_fused_kernel=True)
    assert res.steps < 3000 and not res.diverged
    assert tail_launches() >= res.steps
    plain = lasso(D_t, s_t, lam, cfg, use_fused_kernel=False)
    # The kernel sums its squares in another order than torch: the stop
    # may fall one step apart, never more.
    assert abs(res.steps - plain.steps) <= 1


# K1b's cases: (k, done, abstol, the tail's flags, a NaN in x_new).
_N = 12
_TAIL_CASES = {
    "step": (3, 0, 1e-4, {}, False),
    "stop": (3, 0, 1e3, {}, False),
    "last": (_N - 1, 0, 1e-4, {}, False),
    "done": (3, 1, 1e-4, {}, False),
    "past_n": (_N, 0, 1e-4, {}, False),
    "nodualerror": (3, 0, 1e3, {"nodualerror": True}, False),
    "domaxiters": (3, 0, 1e3, {"domaxiters": True}, False),
    "nan": (3, 0, 1e-4, {}, True),
}


def _tail_operands(dev, dtype, n, k, done, abstol, nan):
    """One K1b call's operands, (x_new, x, z, u, lam, rho, state, hist), and
    its keywords."""
    rng = np.random.default_rng(n)
    vecs = [torch.from_numpy(rng.standard_normal(n)).to(dev, dtype) for _ in range(4)]
    if nan:
        vecs[0][n // 2] = float("nan")
    lam = torch.tensor(0.3, dtype=dtype, device=dev)
    rho = torch.tensor(1.7, dtype=dtype, device=dev)
    state = torch.tensor([k, done, 0], dtype=torch.int64, device=dev)
    hist = torch.full((5, _N + 1), float("nan"), dtype=dtype, device=dev)
    kw = dict(perr_abs=float(np.sqrt(n)) * abstol, derr_abs=float(np.sqrt(n)) * abstol,
              reltol=1e-3, domaxiters=False, nodualerror=False, nanguard=True)
    return [*vecs, lam, rho, state, hist], kw


def _same_bits(a, b):
    if a.dtype.is_floating_point:
        bits = torch.int32 if a.dtype == torch.float32 else torch.int64
        a, b = a.view(bits), b.view(bits)
    return torch.equal(a, b)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("n", [1, 7, 1000, 5000, 70000])
@pytest.mark.parametrize("case", list(_TAIL_CASES))
def test_tail_mode_matches_plain(cuda, tail_launches, n, dtype, case):
    k, done, abstol, flags, nan = _TAIL_CASES[case]
    ops, kw = _tail_operands(cuda, dtype, n, k, done, abstol, nan)
    kw.update(flags)
    before, plain, kern, again = ([t.clone() for t in ops] for _ in range(4))
    _fused_zu_tail_torch(*plain, **kw)
    fused_zu_tail(*kern, **kw)
    fused_zu_tail(*again, **kw)
    torch.cuda.synchronize()
    assert tail_launches() == 2
    # x, z, u and the state bit for bit; the same bits from both launches.
    for i in (1, 2, 3, 6):
        assert _same_bits(kern[i], plain[i]) and _same_bits(kern[i], again[i])
    assert _same_bits(kern[7], again[7])
    frozen = case in ("done", "past_n")
    if frozen:
        for i in (1, 2, 3, 6):
            assert _same_bits(kern[i], before[i])
    # Only column `slot` of rows 0-3 is written, NaN where the plain one is.
    slot = _N if frozen else k
    hk, hp = kern[7].cpu(), plain[7].cpu()
    assert torch.equal(torch.isnan(hk), torch.isnan(hp))
    assert torch.isnan(hk[4]).all()
    written = ~torch.isnan(hp)
    assert (written.nonzero()[:, 1] == slot).all()
    rtol = 1e-5 if dtype == torch.float32 else 1e-12
    torch.testing.assert_close(hk[written], hp[written], rtol=rtol, atol=0)
    if not nan:
        # Built away from ties: the norms and their bars lie far more than
        # rtol apart, so the flags are decided by the values alone.
        col = hp[:4, slot].double().numpy()
        assert abs(col[0] - col[2]) > 1e3 * rtol * col[2]
        assert np.isnan(col[1]) or abs(col[1] - col[3]) > 1e3 * rtol * col[3]


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("n", [7, 1001])
def test_tail_mode_off_16_byte_boundaries(cuda, dtype, n):
    # Vectors one element past a 16-byte boundary take the scalar loop.
    ops, kw = _tail_operands(cuda, dtype, n, 3, 0, 1e-4, False)
    plain = [t.clone() for t in ops]
    kern = [torch.empty(n + 1, dtype=dtype, device=cuda)[1:].copy_(t) for t in ops[:4]]
    kern += [t.clone() for t in ops[4:]]
    assert all(t.data_ptr() % 16 for t in kern[:4])
    _fused_zu_tail_torch(*plain, **kw)
    fused_zu_tail(*kern, **kw)
    for i in (1, 2, 3, 6):
        assert _same_bits(kern[i], plain[i])
    rtol = 1e-5 if dtype == torch.float32 else 1e-12
    torch.testing.assert_close(kern[7][:4, 3], plain[7][:4, 3], rtol=rtol, atol=0)


def test_tail_wrapper_refuses_what_the_kernel_does_not_take(cuda):
    ops, kw = _tail_operands(cuda, torch.float32, 16, 3, 0, 1e-4, False)
    bad = list(ops)
    bad[2] = ops[2].double()
    with pytest.raises(ValueError, match="z is"):
        fused_zu_tail(*bad, **kw)
    bad = list(ops)
    bad[7] = ops[7].t().contiguous().t()
    with pytest.raises(ValueError, match="contiguous"):
        fused_zu_tail(*bad, **kw)
    bad = list(ops)
    bad[3] = ops[3].cpu()
    with pytest.raises(ValueError, match="u is"):
        fused_zu_tail(*bad, **kw)


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
    # Tile boundaries of the hybrid form (tiles of 512 rows or more, halo
    # 2^k - 1; ops/tridiag.py::tile_plan):
    (1, 3077, 63, _random_system),    # n just past the third tile
    (3, 3072, 63, _tv_system),        # n on a tile boundary
    (1, 2049, 7, _random_system),     # halo 511, half a tile
    (3, 65537, 1023, _tv_system),     # halo 255, 256 tiles, most of them padding
    (128, 8192, 1023, _tv_system),    # the batched TV lanes
    (128, 1000, 63, _random_system),
    (3, 20000, None, _tv_system),     # one tile per lane: shared f32, global f64
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


@pytest.fixture
def k2_launches(monkeypatch):
    monkeypatch.setattr(gemv_pair, "launches", 0)
    return lambda: gemv_pair.launches


def _off_stride(A):
    """A copy of ``A`` in storage whose rows are one element longer, so
    that no row after the first starts on a 16-byte boundary."""
    out = A.new_zeros((A.shape[0], A.shape[1] + 1))[:, : A.shape[1]]
    out.copy_(A)
    return out


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("K", [1, 5])
@pytest.mark.parametrize("m,n,aligned", [
    (1, 1, True), (7, 33, True), (7, 33, False), (33, 7, True), (48, 160, True),
    (129, 1000, False), (1000, 129, True), (20, 9000, True), (9000, 20, True),
    (1500, 5000, True), (5000, 1500, True), (1500, 5000, "stride"),
])
def test_gemv_pair_kernel_matches_plain(cuda, k2_launches, dtype, K, m, n, aligned):
    b, E, Dt = make_operands(m, n, cuda, dtype)
    if aligned == "stride":  # row strides of n + 1 and m + 1 elements
        E, Dt = _off_stride(E), _off_stride(Dt)
    elif not aligned:  # rows off 16-byte boundaries: the scalar loads
        E, Dt = E.contiguous(), Dt.contiguous()
    x = gemv_pair(b, E, Dt, K)
    torch.cuda.synchronize()
    assert k2_launches() == 1 and x.dtype == torch.float32 and x.shape == (n,)
    ref = _gemv_pair_torch(b, E, Dt, K)
    assert torch.isfinite(x).all()
    # f32 sums in another order; in bf16 that can also move one rounding of
    # b or t to the neighbouring bf16 value (2^-8 relative), which K > 1
    # carries on.
    if K == 1:
        bar = 1e-5 if dtype == torch.float32 else 1e-3
        assert torch.max(torch.abs(x - ref)) <= bar * torch.max(torch.abs(ref))
    else:
        bar = 1e-4 if dtype == torch.float32 else 2e-2
        assert torch.linalg.norm(x - ref) <= bar * torch.linalg.norm(ref)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("m,n", [(1500, 5000), (5000, 1500), (37, 101)])
def test_gemv_pair_kernel_gives_the_same_bits_every_launch(cuda, dtype, m, n):
    b, E, Dt = make_operands(m, n, cuda, dtype)
    for K in (1, 7):
        first = gemv_pair(b, E, Dt, K)
        assert all(torch.equal(gemv_pair(b, E, Dt, K), first) for _ in range(3))


@pytest.mark.parametrize("m,n", [(1500, 5000), (48, 160)])
def test_gemv_pair_kernel_rounds_an_f32_b(cuda, m, n):
    # The kernel rounds an f32 b to bf16 as it reads it: the same bits as
    # handing it b.to(torch.bfloat16).
    _, E, Dt = make_operands(m, n, cuda, torch.bfloat16)
    b = torch.from_numpy(np.random.default_rng(m).standard_normal(n)).to(cuda, torch.float32)
    assert torch.equal(gemv_pair(b, E, Dt), gemv_pair(b.to(torch.bfloat16), E, Dt))


def _lasso_operands(m, n, device, seed=4):
    rng = np.random.default_rng(seed)
    D = rng.standard_normal((m, n))
    D = torch.from_numpy(D / np.sqrt(np.sum(D**2, axis=0, keepdims=True))).float().to(device)
    s = torch.from_numpy(rng.standard_normal(m)).float().to(device)
    fat = FatShiftSolver.from_matrix(D, 1.0)  # E comes column-major from the solve
    Dts = D.T @ s
    kappa = 0.1 * float(torch.max(torch.abs(Dts)))
    return aligned_rows(fat.E), aligned_rows(D.T), Dts, kappa


@pytest.mark.parametrize("m,n", [(1, 3), (37, 101), (300, 1000), (20, 9000), (1500, 5000)])
def test_resident_lasso_kernel_matches_plain(cuda, monkeypatch, m, n):
    monkeypatch.setattr(resident_lasso, "launches", 0)
    E, Dt, Dts, kappa = _lasso_operands(m, n, cuda)
    K = 16
    z, u = torch.zeros(n, device=cuda), torch.zeros(n, device=cuda)
    hist = resident_lasso(z, u, Dts, E, Dt, 1.0, kappa, K)
    torch.cuda.synchronize()
    assert resident_lasso.launches == 1 and hist.shape == (K, 2)
    zp, up = torch.zeros_like(z), torch.zeros_like(u)
    hp = _resident_lasso_torch(zp, up, Dts, E, Dt, 1.0, kappa, K)
    # f32 sums in another order: a few ulps per step, carried 16 steps.
    for got, ref in ((z, zp), (u, up)):
        assert torch.max(torch.abs(got - ref)) <= 1e-4 * torch.max(torch.abs(ref)) + 1e-30
    # Each norm where it is well above the f32 noise of x and z (the two
    # runs differ by about eps_f32 ||x||): 1e-7 of its largest value.
    for col in (0, 1):
        big = hp[:, col] >= 1e-7 * hp[:, col].max()
        assert torch.allclose(hist[big, col], hp[big, col], rtol=1e-3, atol=0), (
            col, hist[:, col], hp[:, col])
    # Fixed reduction order: the same launch gives the same bits.
    z2, u2 = torch.zeros_like(z), torch.zeros_like(u)
    assert torch.equal(resident_lasso(z2, u2, Dts, E, Dt, 1.0, kappa, K), hist)
    assert torch.equal(z2, z) and torch.equal(u2, u)


def test_gemv_pair_wrappers_refuse_what_the_kernels_do_not_take(cuda):
    b, E, Dt = make_operands(8, 24, cuda, torch.float32)
    with pytest.raises(ValueError, match="on"):
        gemv_pair(b.cpu(), E, Dt)  # a CPU tensor handed to the launcher
    with pytest.raises(TypeError, match="stream dtype"):
        gemv_pair(b.double(), E.double(), Dt.double())
    with pytest.raises(ValueError, match="row-major"):
        gemv_pair(b, Dt.T, Dt)  # unit row stride, not column
    with pytest.raises(ValueError, match="K must be"):
        gemv_pair(b, E, Dt, 0)
    z = torch.zeros(24, device=cuda)
    with pytest.raises(ValueError, match="on"):
        resident_lasso(z.cpu(), z, b, E, Dt, 1.0, 0.1, 4)
    with pytest.raises(TypeError, match="float32"):
        resident_lasso(z.double(), z.double(), b.double(), E.double(), Dt.double(),
                       1.0, 0.1, 4)
    with pytest.raises(ValueError, match="contiguous"):
        resident_lasso(torch.zeros(48, device=cuda)[::2], z, b, E, Dt, 1.0, 0.1, 4)
    with pytest.raises(ValueError, match="K must be"):
        resident_lasso(z, z.clone(), b, E, Dt, 1.0, 0.1, 0)


def _fat_instance(seed=5, m=64, n=200):
    rng = np.random.default_rng(seed)
    D = rng.standard_normal((m, n))
    D = (D / np.sqrt(np.sum(D**2, axis=0, keepdims=True))).astype(np.float32)
    s = (D @ (rng.standard_normal(n) * (rng.random(n) < 0.2))).astype(np.float32)
    return D, s, float(0.1 * np.max(np.abs(D.T @ s)))


def test_numpy_inputs_without_a_device_solve_on_the_card(cuda):
    D, s, lam = _fat_instance()
    cfg = ADMMConfig(maxiters=5, domaxiters=True)
    sig = np.repeat(np.random.default_rng(1).standard_normal(40), 64)
    for res in (lasso(D, s, lam, cfg), elasticnet(D, s, lam, 0.5, cfg), nnls(D, s, cfg),
                grouplasso(D, s, lam, 20, None, cfg), totalvariation(sig, 0.5, cfg),
                totalvariation2d(D, 0.5, cfg),
                admm(lambda x, z, u, rho: 0.5 * (z - u), lambda x, z, u, rho: x + u,
                     cfg, m=8)):
        assert res.steps == 5 and res.xopt.device.type == "cuda"


@pytest.mark.parametrize("solver", ["lasso", "grouplasso"])
def test_bf16_streams_on_gpu_go_through_the_kernel(cuda, k2_launches, solver):
    D, s, lam = _fat_instance()
    cfg = ADMMConfig(maxiters=47, domaxiters=True, unroll=4)

    def solve(device):
        if solver == "lasso":
            return lasso(D, s, lam, cfg, stream_dtype=torch.bfloat16, device=device)
        return grouplasso(D, s, lam, 20, None, cfg, stream_dtype=torch.bfloat16,
                          device=device)

    res = solve(cuda)
    assert res.steps == 47 and res.xopt.device.type == "cuda"
    assert k2_launches() == 48  # 12 chunks of 4 sub-steps, frozen ones too
    cpu = solve("cpu")
    assert k2_launches() == 48
    # The same bf16 rounding points on both devices; a different summation
    # order can move a rounding of b or E b by one bf16 ulp.
    ref = cpu.xopt.numpy()
    assert np.linalg.norm(res.xopt.cpu().numpy() - ref) <= 2e-2 * np.linalg.norm(ref)


# Slice 2's options: (config, lasso keywords, the kernel each step runs).
_SLICE2 = {
    "rbadaptive": (dict(rbadaptive=True), dict(use_fused_kernel=True), "k1"),
    "adaptive": (dict(adaptive=True, convtest=True, stopcond="both"), {}, None),
    "hnorm": (dict(stopcond="hnorm"), dict(use_fused_kernel=True), "k1"),
    "both_convtest": (dict(stopcond="both", convtest=True), dict(use_fused_kernel=True), "k1"),
    "stallwindow": (dict(stallwindow=4), dict(use_fused_kernel=True), "k1"),
    "anderson": (dict(anderson=5), dict(use_fused_kernel=True), "k1"),
    "record_iterates": (dict(record_iterates=True), dict(use_fused_kernel=True), "k1"),
    "fast_weak": (dict(fast=True), dict(stream_dtype=torch.bfloat16), "k2"),
    "fast_strong": (dict(fast=True, fasttype="strong"), dict(stream_dtype=torch.bfloat16), "k2"),
    "quiet_objevals": (dict(quiet=False, objevals=True), dict(use_fused_kernel=True), "k1b"),
}


@pytest.mark.parametrize("name", list(_SLICE2))
def test_slice2_chunk_on_the_headline_reads_nothing_back(cuda, monkeypatch, launches,
                                                         tail_launches, k2_launches, name):
    # One chunk of 8 sub-steps on the 1500 x 5000 f32 headline problem:
    # no synchronising call inside the sub-steps, one read of the stop flag
    # after them, and the step's kernel launched by every sub-step.
    kw, extra, kernel = _SLICE2[name]
    D, s, lam = make_problem()
    K = 8
    syncs, reads = [], []
    run_chunks = engine_mod._run_chunks

    def counted(step, flags, N, K_, table=None):
        def one_step():
            with warnings.catch_warnings(record=True) as seen:
                warnings.simplefilter("always")
                torch.cuda.set_sync_debug_mode("warn")
                try:
                    step()
                finally:
                    torch.cuda.set_sync_debug_mode("default")
            syncs.extend(str(w.message) for w in seen if "called a synchronizing" in str(w.message))

        def read():
            reads.append(1)
            return flags()

        return run_chunks(one_step, read, N, K_, table)

    monkeypatch.setattr(engine_mod, "_run_chunks", counted)
    res = lasso(D, s, lam, ADMMConfig(maxiters=K, unroll=K, **kw), device=cuda, **extra)
    assert syncs == [] and reads == [1]
    assert torch.isfinite(res.xopt).all() and 1 <= res.steps <= K
    assert (launches(), tail_launches(), k2_launches()) == {
        "k1": (K, 0, 0), "k1b": (0, K, 0), "k2": (0, 0, K), None: (0, 0, 0)}[kernel]


@pytest.mark.parametrize("name", [n for n in _SLICE2 if n != "quiet_objevals"])
def test_slice2_options_on_gpu_match_the_cpu(cuda, name):
    # f64 on both devices, f64 streams (bf16 streams round alike but sum
    # in other orders): cuBLAS, cuSOLVER and the CPU's LAPACK round
    # differently, so the bars are those of a parity test.
    kw, extra, _ = _SLICE2[name]
    extra = {k: v for k, v in extra.items() if k != "stream_dtype"}
    D, s, lam = _fat_instance()
    D, s = D.astype(np.float64), s.astype(np.float64)
    cfg = ADMMConfig(maxiters=60, unroll=4, **kw)
    res = lasso(D, s, lam, cfg, device=cuda, **extra)
    cpu = lasso(D, s, lam, cfg, device="cpu", **extra)
    assert res.steps == cpu.steps and res.diverged == cpu.diverged
    assert res.stalled == cpu.stalled
    np.testing.assert_allclose(res.rho_final, cpu.rho_final, rtol=1e-12)
    np.testing.assert_allclose(res.xopt.cpu().numpy(), cpu.xopt.numpy(), rtol=1e-9, atol=1e-10)
    assert set(res.hist) == set(cpu.hist)
    for key in cpu.hist:
        ref = cpu.trace(key)
        scale = np.max(np.abs(ref[0])) or np.nanmax(np.abs(ref))
        np.testing.assert_allclose(res.trace(key), ref, rtol=0, atol=1e-8 * scale)


def test_model_on_gpu_matches_the_cpu(cuda):
    rng = np.random.default_rng(7)
    P, Q = rng.standard_normal((64, 48)), rng.standard_normal((64, 48))
    r, s = rng.standard_normal(64), rng.standard_normal(64)
    for kw in (dict(), dict(fast=True, maxiters=200), dict(rbadaptive=True, rho=0.01)):
        cfg = ADMMConfig(**dict(dict(maxiters=2000, unroll=4), **kw))
        res = model(P, Q, r, s, cfg, device=cuda)
        cpu = model(P, Q, r, s, cfg, device="cpu")
        assert res.xopt.device.type == "cuda" and res.steps == cpu.steps
        np.testing.assert_allclose(res.xopt.cpu().numpy(), cpu.xopt.numpy(), rtol=1e-9,
                                   atol=1e-10)


def _family_solvers():
    """Slices 3, 4, 5 and 7 at small sizes: family -> solve(dtype, config,
    device), on numpy inputs made from one seed."""
    rng = np.random.default_rng(9)
    Dfat = rng.standard_normal((40, 160))
    s_bp = Dfat @ (rng.standard_normal(160) * (rng.random(160) < 0.1))
    D, s = rng.standard_normal((300, 30)), rng.standard_normal(300)
    ell = np.sign(D @ rng.standard_normal(30) + 0.1 * rng.standard_normal(300))
    sig = np.repeat(rng.standard_normal(16), 32) + 0.5 * rng.standard_normal(512)
    Dlp = np.abs(rng.standard_normal((32, 64)))
    s_lp, b_lp = Dlp @ np.abs(rng.standard_normal(64)), rng.random(64) + 0.5
    G = rng.standard_normal((64, 64))
    P, q = G @ G.T / 64 + np.eye(64), 3.0 * rng.standard_normal(64)
    box = (-0.5 * np.ones(64), 0.5 * np.ones(64))
    Dcov = rng.standard_normal((256, 32))
    C, A, b, *_ = random_sdp_instance(12, 16, 4, rng)
    W = np.triu(rng.random((24, 24)) < 0.3, 1).astype(np.float64)
    lap = np.diag((W + W.T).sum(-1)) - (W + W.T)
    lp = lambda dt, cfg, dev, **kw: linearprogram(  # noqa: E731
        b_lp.astype(dt), Dlp.astype(dt), s_lp.astype(dt), cfg, device=dev, **kw)
    return {
        "linearprogram": lp,
        "linearprogram_chol": lambda dt, cfg, dev: lp(dt, cfg, dev, kkt_mode="chol"),
        "linearprogram_dynamic": lambda dt, cfg, dev: lp(dt, dataclasses.replace(
            cfg, rbadaptive=True), dev),
        "quadraticprogram": lambda dt, cfg, dev: quadraticprogram(
            P.astype(dt), q.astype(dt), 0.5, Dlp.astype(dt), s_lp.astype(dt), cfg, device=dev),
        "quadraticprogram_bounded": lambda dt, cfg, dev: quadraticprogram(
            P.astype(dt), q.astype(dt), 0.5, *(v.astype(dt) for v in box), cfg, device=dev),
        "quadraticprogram_bounded_dynamic": lambda dt, cfg, dev: quadraticprogram(
            P.astype(dt), q.astype(dt), 0.5, *(v.astype(dt) for v in box),
            dataclasses.replace(cfg, rbadaptive=True), device=dev),
        "covsel_ns": lambda dt, cfg, dev: covarianceselection(Dcov.astype(dt), 0.2, cfg,
                                                              prox_method="ns", device=dev),
        "covsel_ns_fast": lambda dt, cfg, dev: covarianceselection(
            Dcov.astype(dt), 0.2, cfg, prox_method="ns_fast", device=dev),
        "sdp_dense_ns": lambda dt, cfg, dev: sdp(C.astype(dt), A.astype(dt), b.astype(dt), cfg,
                                                 prox_method="ns", ns_iters=30, device=dev),
        "sdp_diag_ns": lambda dt, cfg, dev: sdp((-0.25 * lap).astype(dt), "diag",
                                                np.ones(24, dt), cfg, prox_method="ns",
                                                ns_iters=30, device=dev),
        "covsel_eigh": lambda dt, cfg, dev: covarianceselection(Dcov.astype(dt), 0.2, cfg,
                                                                device=dev),
        "sdp_dense_eigh": lambda dt, cfg, dev: sdp(C.astype(dt), A.astype(dt), b.astype(dt), cfg,
                                                   device=dev),
        "sdp_diag_eigh": lambda dt, cfg, dev: sdp((-0.25 * lap).astype(dt), "diag",
                                                  np.ones(24, dt), cfg, device=dev),
        "basispursuit": lambda dt, cfg, dev: basispursuit(Dfat.astype(dt), s_bp.astype(dt), cfg,
                                                          device=dev),
        "fusedlasso": lambda dt, cfg, dev: fusedlasso(sig.astype(dt), 0.1, 0.5, cfg, device=dev),
        "lad": lambda dt, cfg, dev: lad(D.astype(dt), s.astype(dt), cfg, device=dev),
        "huberfit": lambda dt, cfg, dev: huberfit(D.astype(dt), s.astype(dt), cfg, device=dev),
        "quantile": lambda dt, cfg, dev: quantile(D.astype(dt), s.astype(dt), 0.8, cfg,
                                                  device=dev),
        "linearsvm": lambda dt, cfg, dev: linearsvm(D.astype(dt), ell.astype(dt), 1.0, cfg,
                                                    device=dev),
    }


# matrix.py's f32 bars on the objective, and for the fused lasso on xopt
# (relative norm); basis pursuit is held as chip_smoke.py (s) holds it:
# xopt at 1e-3 (the stall window stops f32 and f64 short of the optimum)
# and the tester's constraint error at matrix.py's 1e-4.  The LP is held
# to its 1e-4 on the objective, the QP to its 5e-3 on x, covsel to its
# 1e-3 and the SDP to its eigh gap bar, 1e-3, on the objective.  The eigh
# paths (_EIGH) read cuSOLVER's info back once a call and are held apart.
_FAMILY_BARS = {"basispursuit": ("x", 1e-3), "fusedlasso": ("x", 1e-3), "lad": ("obj", 1e-2),
                "huberfit": ("obj", 1e-3), "quantile": ("obj", 1e-2), "linearsvm": ("obj", 1e-3),
                "linearprogram": ("obj", 1e-4), "linearprogram_chol": ("obj", 1e-4),
                "linearprogram_dynamic": ("obj", 1e-4), "quadraticprogram": ("x", 5e-3),
                "quadraticprogram_bounded": ("x", 5e-3),
                "quadraticprogram_bounded_dynamic": ("x", 5e-3), "covsel_ns": ("obj", 1e-3),
                "covsel_ns_fast": ("obj", 1e-3), "sdp_dense_ns": ("obj", 1e-3),
                "sdp_diag_ns": ("obj", 1e-3)}
_EIGH = {"covsel_eigh": ("obj", 1e-3), "sdp_dense_eigh": ("obj", 1e-3),
         "sdp_diag_eigh": ("obj", 1e-3)}


def _chunk_syncs(monkeypatch, solve, K):
    """Run ``solve`` with the engine's chunks counted: the synchronising
    calls of each sub-step and the reads of the stop flag."""
    syncs, reads = [], []
    run_chunks = engine_mod._run_chunks

    def counted(step, flags, N, K_, table=None):
        def one_step():
            with warnings.catch_warnings(record=True) as seen:
                warnings.simplefilter("always")
                torch.cuda.set_sync_debug_mode("warn")
                try:
                    step()
                finally:
                    torch.cuda.set_sync_debug_mode("default")
            syncs.append(sum("called a synchronizing" in str(w.message) for w in seen))

        def read():
            reads.append(1)
            return flags()

        return run_chunks(one_step, read, N, K_, table)

    monkeypatch.setattr(engine_mod, "_run_chunks", counted)
    return solve(), syncs, reads


@pytest.mark.parametrize("family", sorted(_FAMILY_BARS))
def test_family_chunk_reads_nothing_back(cuda, monkeypatch, launches, tail_launches, k2_launches,
                                         cr_launches, family):
    # One chunk of 8 sub-steps: no synchronising call inside them, one
    # read of the stop flag after them, and no kernel launched.
    K = 8
    res, syncs, reads = _chunk_syncs(monkeypatch, lambda: _family_solvers()[family](
        np.float32, ADMMConfig(maxiters=K, unroll=K), None), K)
    assert syncs == [0] * K and reads == [1]
    assert res.xopt.device.type == "cuda" and torch.isfinite(res.xopt).all()
    assert (launches(), tail_launches(), k2_launches(), cr_launches()) == (0, 0, 0, 0)


@pytest.mark.parametrize("family", sorted(_EIGH))
def test_eigh_chunk_syncs_once_a_sub_step(cuda, monkeypatch, launches, tail_launches,
                                          k2_launches, cr_launches, family):
    # torch.linalg.eigh has no _ex form: cuSOLVER's info is read back on
    # the host in every call, one synchronising call per sub-step (recorded
    # in ROADMAP.md queue 2: a captured chunk cannot hold it).  Every
    # sub-step makes the same count, and no kernel runs.
    K = 8
    res, syncs, reads = _chunk_syncs(monkeypatch, lambda: _family_solvers()[family](
        np.float32, ADMMConfig(maxiters=K, unroll=K), None), K)
    print(f"{family}: synchronising calls per sub-step {syncs}")
    assert syncs == [syncs[0]] * K and 1 <= syncs[0] <= 2 and reads == [1]
    assert res.xopt.device.type == "cuda" and torch.isfinite(res.xopt).all()
    assert (launches(), tail_launches(), k2_launches(), cr_launches()) == (0, 0, 0, 0)


@pytest.mark.parametrize("n", [16, 40, 128, 512])
def test_f32_spectral_proxes_on_gpu_track_f64(cuda, n):
    # torch's own f32 eigh on the card is cuSOLVER's Jacobi syevj from
    # order 32 to 512; ops/prox.sym_eigh decomposes f32 matrices in f64
    # there, so one f32 prox stays within 1e-5 of the f64 one (LAPACK's
    # f32 eigh reads ~1e-6 on such matrices, a bf16 input ~1e-3).
    from admm_tpu_torch.ops.prox import covsel_eig_prox, psd_project

    G = np.random.default_rng(n).standard_normal((n, n))
    W = torch.from_numpy((G + G.T) / np.sqrt(2 * n)).to(cuda)
    for prox in (psd_project, lambda M: covsel_eig_prox(M, 1.0)):
        out, ref = prox(W.float()), prox(W)
        assert out.dtype == torch.float32
        assert torch.linalg.norm(out.double() - ref) <= 1e-5 * torch.linalg.norm(ref)


@pytest.mark.parametrize("family", sorted({**_FAMILY_BARS, **_EIGH}))
def test_family_f32_on_gpu_within_its_bar(cuda, family):
    cfg = ADMMConfig(maxiters=20000, abstol=1e-7, reltol=1e-6, stallwindow=100, unroll="auto",
                     objevals=True)
    solve = _family_solvers()[family]
    r32, r64 = solve(np.float32, cfg, cuda), solve(np.float64, cfg, cuda)
    assert r32.xopt.dtype == torch.float32 and r32.xopt.device.type == "cuda"
    kind, bar = {**_FAMILY_BARS, **_EIGH}[family]
    if kind == "x":
        err = torch.linalg.norm(r32.xopt.double() - r64.xopt) / torch.linalg.norm(r64.xopt)
        if family == "basispursuit":
            rng = np.random.default_rng(9)  # _family_solvers' D and s
            D = rng.standard_normal((40, 160))
            s = D @ (rng.standard_normal(160) * (rng.random(160) < 0.1))
            Dx = D @ r32.xopt.double().cpu().numpy()
            assert np.mean(np.abs((Dx - s) / Dx)) <= 1e-4
    else:
        err = abs(r32.objopt - r64.objopt) / abs(r64.objopt)
    assert err <= bar


@pytest.mark.parametrize("family", sorted({**_FAMILY_BARS, **_EIGH}))
def test_family_on_gpu_matches_the_cpu(cuda, family):
    # f64 on both devices: cuBLAS, cuSOLVER and the CPU's LAPACK round
    # differently, so the bars are those of a parity test.  The SVM's
    # random start is drawn on the CPU for both.
    cfg = ADMMConfig(maxiters=300, unroll=4, objevals=True)
    solve = _family_solvers()[family]
    res, cpu = solve(np.float64, cfg, cuda), solve(np.float64, cfg, "cpu")
    assert res.steps == cpu.steps and res.diverged == cpu.diverged
    np.testing.assert_allclose(res.xopt.cpu().numpy(), cpu.xopt.numpy(), rtol=1e-9, atol=1e-10)
    for key in ("pnorm", "objvals"):
        ref = cpu.trace(key)
        np.testing.assert_allclose(res.trace(key), ref, rtol=0, atol=1e-8 * np.max(np.abs(ref)))


def test_registry_closures_on_gpu(cuda):
    rng = np.random.default_rng(3)
    D, s = rng.standard_normal((40, 10)), rng.standard_normal(40)
    pf, pg, obj = get_prox_ops("quantile", D=D, s=s, tau=0.3)  # the card by default
    x, z = torch.zeros(10, device=cuda, dtype=torch.float64), torch.zeros(40, device=cuda,
                                                                         dtype=torch.float64)
    out = pg(pf(x, z, z, 1.0), z, z, 1.0)
    assert out.device.type == "cuda" and torch.isfinite(out).all()
