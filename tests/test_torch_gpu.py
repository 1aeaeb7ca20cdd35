"""The port on a CUDA device: the CUDA C++ z/u kernel in its modes (K1,
the z/u pass; K1b, the pass with the whole engine tail; K1b's
difference-operator mode, 1-D TV's whole tail, at stencil, warp, block and
tile edges, and a TV solve through it against the generic tail) and the
cyclic-reduction, GEMV-pair and resident-LASSO kernels against their
plain PyTorch versions, the cyclic-reduction precompute built on the card
against the CPU build, the LASSO, group-lasso and TV slices going
through them, and the engine variants (slice 2): one chunk of each on the
headline problem without a synchronising call inside its steps, and each
against the same solve on the CPU; and the families of slices 3 and 4
(basis pursuit, fused lasso, LAD, Huber, quantile, linear SVM) and of
slices 5 and 7 (the LP and QP on their KKT solvers, covariance selection
and the SDP, robust PCA, matrix completion and logistic regression) and
the lanes of slice 8 (batches and paths), which run no kernel but the
TV lanes' K4: one chunk of each without a
synchronising call inside it (the eigh paths' calls counted and
recorded), f32 against f64 on the card to
admm_tpu/benchmarks/matrix.py's f32 bars, and f64 on the card against the
CPU; and the same three for every runner of the distributed layer
(slice 10a, W shards stacked on the card); and its process groups (slice
10b): a one-rank NCCL group equal to the stacked run bit for bit, two
gloo ranks sharing the card, and ``initialize_cluster`` refusing NCCL
ranks on one card; and slice 10c: a reduction over a one-rank NCCL group
under ``torch.func.vmap`` as one all_reduce of CUDA tensors, two gloo
ranks holding each lane's shards between them, vmap of grad over the
serial TV solve through K4, and ``solver='cr_packed'`` on the card
against the CPU.

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
from admm_tpu_torch.linop import DiffOp
from admm_tpu_torch.ops.kernels import (
    _fused_torch, _fused_zu_tail_torch, fused_diff_tail, fused_soft_threshold_dual,
    fused_zu_tail, zu_tail_scratch)
from admm_tpu_torch.ops.solve import FatShiftSolver
from admm_tpu_torch.ops.tridiag import (
    CyclicReductionSolver, _cr_solve_torch, compact_stacks, cr_solve)

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


@pytest.fixture
def diff_launches(monkeypatch):
    monkeypatch.setattr(fused_diff_tail, "launches", 0)
    return lambda: fused_diff_tail.launches


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
    _check_tail_call(cuda, n, dtype, case, fused_zu_tail, None)
    assert tail_launches() == 2


# The difference-operator mode at one element, the stencils' ends, warp,
# block and tile edges (a tile is 256 chunks of 16 bytes: 1024 elements in
# f32, 512 in f64; a block holds whole tiles), the TV cell's n and past it.
_DIFF_NS = [1, 2, 3, 255, 256, 257, 513, 1024, 1025, 4097, 65536, 65537]


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("n", _DIFF_NS)
@pytest.mark.parametrize("case", list(_TAIL_CASES))
def test_diff_tail_mode_matches_plain(cuda, diff_launches, n, dtype, case):
    _check_tail_call(cuda, n, dtype, case, fused_diff_tail, DiffOp(n))
    assert diff_launches() == 2


def _check_tail_call(cuda, n, dtype, case, kernel, op):
    """One call of ``kernel`` (K1b, or its difference-operator mode with
    ``op``) on ``_TAIL_CASES[case]``'s operands, twice, against the plain
    version."""
    k, done, abstol, flags, nan = _TAIL_CASES[case]
    ops, kw = _tail_operands(cuda, dtype, n, k, done, abstol, nan)
    kw.update(flags)
    before, plain, kern, again = ([t.clone() for t in ops] for _ in range(4))
    _fused_zu_tail_torch(*plain, op=op, **kw)
    kernel(*kern, **kw)
    kernel(*again, **kw)
    torch.cuda.synchronize()
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
@pytest.mark.parametrize("n", [7, 1001, 4099])
def test_diff_tail_mode_off_16_byte_boundaries(cuda, dtype, n):
    # Vectors one element past a 16-byte boundary take the scalar loads.
    ops, kw = _tail_operands(cuda, dtype, n, 3, 0, 1e-4, False)
    plain = [t.clone() for t in ops]
    kern = [torch.empty(n + 1, dtype=dtype, device=cuda)[1:].copy_(t) for t in ops[:4]]
    kern += [t.clone() for t in ops[4:]]
    assert all(t.data_ptr() % 16 for t in kern[:4])
    _fused_zu_tail_torch(*plain, op=DiffOp(n), **kw)
    fused_diff_tail(*kern, **kw)
    for i in (1, 2, 3, 6):
        assert _same_bits(kern[i], plain[i])
    rtol = 1e-5 if dtype == torch.float32 else 1e-12
    torch.testing.assert_close(kern[7][:4, 3], plain[7][:4, 3], rtol=rtol, atol=0)


@pytest.mark.parametrize("dtype,n", [(torch.float32, 1_100_003), (torch.float64, 600_001)])
def test_diff_tail_mode_many_tiles_a_block(cuda, diff_launches, dtype, n):
    # Past 1024 blocks of one tile each a block takes several tiles in
    # order (here two): the carry between tiles, and every launch the same
    # bits, history included.
    ops, kw = _tail_operands(cuda, dtype, n, 3, 0, 1e-4, False)
    plain = [t.clone() for t in ops]
    _fused_zu_tail_torch(*plain, op=DiffOp(n), **kw)
    runs = [[t.clone() for t in ops] for _ in range(3)]
    for kern in runs:
        fused_diff_tail(*kern, **kw)
    torch.cuda.synchronize()
    assert diff_launches() == 3
    for i in (1, 2, 3, 6):
        assert _same_bits(runs[0][i], plain[i])
    for kern in runs[1:]:
        for i in (1, 2, 3, 6, 7):
            assert _same_bits(kern[i], runs[0][i])
    rtol = 1e-5 if dtype == torch.float32 else 1e-12
    torch.testing.assert_close(runs[0][7][:4, 3], plain[7][:4, 3], rtol=rtol, atol=0)


def test_diff_tail_wrapper_refuses_a_short_scratch(cuda):
    # K1b's scratch has no room for the edge values.
    ops, kw = _tail_operands(cuda, torch.float32, 5000, 3, 0, 1e-4, False)
    with pytest.raises(ValueError, match="scratch"):
        fused_diff_tail(*ops, scratch=zu_tail_scratch(5000, torch.float32, cuda), **kw)
    fused_diff_tail(*ops, scratch=zu_tail_scratch(5000, torch.float32, cuda, diff=True), **kw)


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
def test_totalvariation_on_gpu_goes_through_the_kernel(cuda, cr_launches, diff_launches, n,
                                                       solver):
    rng = np.random.default_rng(3)
    sig = np.repeat(rng.standard_normal(n // 64 + 1), 64)[:n] + 0.5 * rng.standard_normal(n)
    cfg = ADMMConfig(maxiters=41, domaxiters=True, unroll=4)
    res = totalvariation(sig, 0.5, cfg, solver=solver, device=cuda)
    assert res.steps == 41 and res.xopt.device.type == "cuda"
    # 11 chunks of 4 sub-steps: frozen sub-steps solve too, and each
    # sub-step's tail is one launch of the difference-operator mode.
    assert cr_launches() == 44 and diff_launches() == 44
    plain = totalvariation(sig, 0.5, cfg, solver=solver, device=cuda, _plain_cr=True)
    assert cr_launches() == 44 and diff_launches() == 88
    assert torch.equal(res.xopt, plain.xopt)
    cpu = totalvariation(sig, 0.5, cfg, solver=solver, device="cpu")
    # f64 on both devices; the elementwise steps round alike, the norms
    # and the dense tail sum in other orders.
    np.testing.assert_allclose(res.xopt.cpu().numpy(), cpu.xopt.numpy(),
                               rtol=1e-9, atol=1e-10)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_converging_tv_on_gpu_stops_with_the_plain_tail(cuda, monkeypatch, diff_launches,
                                                       dtype):
    # The TV cell's size and options: the tail in one launch a sub-step
    # against the generic tail, whose sums run in torch's order.
    rng = np.random.default_rng(12)
    n = 65536
    sig = np.repeat(rng.integers(1, 10, 8).astype(float), n // 8) + rng.standard_normal(n)
    sig = torch.from_numpy(sig).to(cuda, dtype)
    cfg = ADMMConfig(abstol=1e-5, reltol=1e-3, unroll="auto")
    res = totalvariation(sig, 5.0, cfg)
    assert diff_launches() >= res.steps and not res.diverged
    monkeypatch.setattr(engine_mod, "_diff_tail_applies", lambda *a: False)
    generic = totalvariation(sig, 5.0, cfg)
    assert diff_launches() < 2 * res.steps
    assert abs(res.steps - generic.steps) <= 1
    if res.steps == generic.steps:
        for name in ("xopt", "zopt", "uopt"):
            assert torch.equal(getattr(res, name), getattr(generic, name))


@pytest.fixture
def precomputes(monkeypatch):
    monkeypatch.setattr(CyclicReductionSolver, "device_precomputes", 0)
    return lambda: CyclicReductionSolver.device_precomputes


_CR_STACKS = ("alphas", "betas", "a_lv", "c_lv", "d_lv", "masks_f", "masks_b")


def _cr_bits(t):
    return t.view({torch.float32: torch.int32, torch.float64: torch.int64}.get(t.dtype, t.dtype))


def _moved_to(sol, device):
    """A solver built on the CPU, its stacks copied to ``device``."""
    moved = CyclicReductionSolver(
        *(getattr(sol, name).to(device) for name in _CR_STACKS), sol.n,
        Tinv=None if sol.Tinv is None else sol.Tinv.to(device), cut_stride=sol.cut_stride,
        bands=sol._bands)
    compact_stacks(moved)
    return moved


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("n,cutoff", [
    (65536, 1023),  # the TV cell: 7 masked levels, then a 1023-row inverse
    (20000, 1023),
    (5000, 63),
    (300, 1023),    # no masked level: the inverse does it all
    (4097, None),   # pure masked
    (1000, None),
    (1, None),
])
@pytest.mark.parametrize("system", [_tv_system, _random_system])
def test_cr_precompute_on_the_card_equals_the_cpu_build(cuda, precomputes, dtype, n, cutoff,
                                                        system):
    # The levels are separate elementwise ops in NumPy's order on both
    # devices, so they round alike: every stack, full and compacted, equal
    # bit for bit.  The inverse is cuSOLVER's against NumPy's LAPACK.
    args = system(n)
    gpu = CyclicReductionSolver.from_tridiag(*args, dense_cutoff=cutoff, device=cuda,
                                             dtype=dtype)
    assert precomputes() == 1
    cpu = CyclicReductionSolver.from_tridiag(*args, dense_cutoff=cutoff, dtype=dtype)
    assert precomputes() == 1
    for name in _CR_STACKS:
        got, ref = getattr(gpu, name), getattr(cpu, name).to(cuda)
        assert got.is_cuda and got.dtype == ref.dtype and got.shape == ref.shape
        assert torch.equal(_cr_bits(got), _cr_bits(ref)), name
    for got, ref in zip(compact_stacks(gpu), compact_stacks(cpu)):
        assert got.is_cuda and torch.equal(_cr_bits(got), _cr_bits(ref.to(cuda)))
    assert (gpu.n, gpu.cut_stride) == (cpu.n, cpu.cut_stride)
    assert (gpu.Tinv is None) == (cpu.Tinv is None) == (cutoff is None)
    if cutoff is not None:
        assert gpu.Tinv.is_cuda and gpu.Tinv.dtype == dtype
        ref = CyclicReductionSolver.from_tridiag(*args, dense_cutoff=cutoff).Tinv.to(cuda)
        # f64 to 1e-13 of the largest entry; f32 one rounding more.
        tol = 1e-13 if dtype == torch.float64 else 2.0**-23
        torch.testing.assert_close(gpu.Tinv.double(), ref, rtol=tol,
                                   atol=tol * float(ref.abs().max()))


@pytest.mark.parametrize("cutoff", [None, 1023])
def test_cr_precompute_on_the_card_waits_for_nothing(cuda, precomputes, cutoff):
    args = tv_system(65536, 1.0)
    CyclicReductionSolver.from_tridiag(*args, dense_cutoff=cutoff, device=cuda)  # loads cuSOLVER
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        sol = CyclicReductionSolver.from_tridiag(*args, dense_cutoff=cutoff, device=cuda,
                                                 dtype=torch.float32)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert precomputes() == 2
    assert sol.alphas.is_cuda and (sol.Tinv is None) == (cutoff is None)


def test_totalvariation_builds_its_solver_on_the_card_every_call(cuda, precomputes,
                                                                  monkeypatch):
    # The TV cell's shape: two calls precompute twice (nothing is kept
    # across calls) and give the steps and iterates of a solver built on
    # the CPU and moved to the card.
    n = 65536
    rng = np.random.default_rng(5)
    sig = np.ones(n)
    for lo, hi, step in ((n // 8, 7 * n // 8, 3.0), (n // 4, 3 * n // 4, 4.0),
                         (3 * n // 8, 5 * n // 8, 2.0)):
        sig[lo:hi] += step
    sig = torch.from_numpy(sig + rng.standard_normal(n)).float().to(cuda)
    cfg = ADMMConfig(maxiters=300)
    runs = [totalvariation(sig, 5.0, cfg) for _ in range(2)]
    assert precomputes() == 2
    tv_mod = importlib.import_module("admm_tpu_torch.models.totalvariation")
    build = CyclicReductionSolver.from_tridiag

    class CPUBuilt:
        @staticmethod
        def from_tridiag(*args, device, dtype, **kw):
            return _moved_to(build(*args, dtype=dtype, **kw), device)

    monkeypatch.setattr(tv_mod, "CyclicReductionSolver", CPUBuilt)
    ref = totalvariation(sig, 5.0, cfg)
    assert precomputes() == 2
    for res in runs:
        assert res.steps == ref.steps
        assert torch.equal(res.xopt, ref.xopt)


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

    def counted(step, flags, N, K_, table=None, **kw):
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

        return run_chunks(one_step, read, N, K_, table, **kw)

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
    calls of each sub-step and the reads of the stop flag.  A sub-step
    replayed from a captured graph runs no host code and makes none."""
    syncs, reads = [], []
    run_chunks = engine_mod._run_chunks

    def counted(step, flags, N, K_, table=None, graph=None, **kw):
        if graph is not None:
            def replayed(step_, flags_, K__):
                before = len(syncs)
                out = graph(step_, flags_, K__)
                syncs.extend([0] * (K__ - (len(syncs) - before)))
                return out

            kw["graph"] = replayed

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

        return run_chunks(one_step, read, N, K_, table, **kw)

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


# --- slices 7b and 8: the serial spectral families and the lanes ---------

def _batch_solvers():
    """The lanes (and the serial slice 7b families) at small sizes in f32
    on the card: {name: (solve(cfg), cuSOLVER reads expected per
    sub-step)}."""
    import admm_tpu_torch as T

    rng = np.random.default_rng(30)
    dev = torch.device("cuda")
    f32 = lambda a: torch.as_tensor(np.asarray(a, np.float32), device=dev)  # noqa: E731
    D, S = f32(rng.standard_normal((40, 96))), f32(rng.standard_normal((4, 40)))
    Sig = f32(np.cumsum(rng.standard_normal((4, 3000)), axis=1))
    Zc = rng.standard_normal((4, 16, 64))
    Sc = f32(Zc @ np.swapaxes(Zc, 1, 2) / 64 + 0.1 * np.eye(16))
    Ms = f32(rng.standard_normal((3, 24, 5)) @ rng.standard_normal((3, 5, 20)))
    Dl = f32(rng.standard_normal((120, 10)))
    ells = f32(np.sign(rng.standard_normal((3, 120))))
    svd = lambda *shape: _svd_syncs(shape)  # noqa: E731
    return {
        "lasso_batch": (lambda c: T.lasso_batch(D, S, 0.1, c), 0),
        "lasso_path": (lambda c: T.lasso_path(D, S[0], f32([0.05, 0.1, 0.2]), c), 0),
        "tv_batch": (lambda c: T.tv_batch(Sig, 1.0, c, solver="cr"), 0),
        "covsel_batch_ns": (lambda c: T.covsel_batch(Sc, 0.05, c), 0),
        "logreg_batch_dense": (lambda c: T.logreg_batch(Dl, ells, 0.1, c, inner="newton"), 0),
        "logreg_batch_cg": (lambda c: T.logreg_batch(Dl, ells, 0.1, c), 0),
        "logreg_dense": (lambda c: T.logreg(Dl, ells[0], 0.1, c), 0),
        "rpca_batch_rsvd": (lambda c: T.rpca_batch(Ms, config=c, prox_method="rsvd", rank=5),
                            svd(3, 15, 20)),
        "rpca_exact": (lambda c: T.rpca(Ms[0], config=c), svd(24, 20)),
        "rpca_batch_exact": (lambda c: T.rpca_batch(Ms, config=c), svd(3, 24, 20)),
        "matrixcompletion_exact": (lambda c: T.matrixcompletion(Ms[0], Ms[0] > 0, config=c),
                                   svd(24, 20)),
    }


def _svd_syncs(shape):
    """The synchronising calls of one ``ops/prox.thin_svd`` of an f32
    matrix (stack) of ``shape`` on the card."""
    from admm_tpu_torch.ops.prox import thin_svd

    V = torch.randn(shape, device="cuda")
    with warnings.catch_warnings(record=True) as seen:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            thin_svd(V)
        finally:
            torch.cuda.set_sync_debug_mode("default")
    return sum("called a synchronizing" in str(w.message) for w in seen)


@pytest.mark.parametrize("name", ["lasso_batch", "lasso_path", "tv_batch", "covsel_batch_ns",
                                  "logreg_batch_dense", "logreg_batch_cg", "logreg_dense",
                                  "rpca_batch_rsvd", "rpca_exact", "rpca_batch_exact",
                                  "matrixcompletion_exact"])
def test_lanes_chunk_reads_nothing_back(cuda, monkeypatch, name):
    # One chunk of 8 sub-steps (K = 8): one read of the stop flag after
    # them, and no synchronising call inside them except the SVD's
    # (torch.linalg.svd has no _ex form: cuSOLVER's info read back every
    # call): each sub-step of the SVT proxes makes exactly the calls of
    # one thin_svd of its shape (the randomized SVT's is the sketch's),
    # the QRs none.  logreg's dense Newton solves through cholesky_ex and
    # reads nothing.
    solve, per_step = _batch_solvers()[name]
    assert name.startswith(("rpca", "matrixcompletion")) == (per_step > 0)
    K = 8
    res, syncs, reads = _chunk_syncs(monkeypatch, lambda: solve(
        ADMMConfig(maxiters=K, unroll=K, domaxiters=True)), K)
    assert reads == [1]
    assert syncs == [per_step] * K, syncs
    assert res.xopt.device.type == "cuda" and torch.isfinite(res.xopt).all()


def test_tv_batch_launches_k4_once_per_substep(cuda, cr_launches):
    # B = 8 lanes of n = 3000 (hybrid, cutoff 1023): one K4 solve of all
    # lanes a sub-step, so the count grows by the sub-steps run.
    import admm_tpu_torch as T

    rng = np.random.default_rng(31)
    S = torch.as_tensor(np.cumsum(rng.standard_normal((8, 3000)), axis=1), dtype=torch.float32,
                        device=cuda)
    res = T.tv_batch(S, 1.0, ADMMConfig(maxiters=40, domaxiters=True), solver="cr")
    assert cr_launches() == 40 and res.steps.tolist() == [40] * 8
    plain = T.tv_batch(S, 1.0, ADMMConfig(maxiters=40, domaxiters=True), solver="cr",
                       _plain_cr=True)
    assert cr_launches() == 40
    scale = float(plain.xopt.abs().max())
    assert float((res.xopt - plain.xopt).abs().max()) <= 1e-6 * scale


@pytest.mark.parametrize("cutoff", [None, 1023])
def test_cr_op_vmap_rule_gives_the_bits_of_a_direct_call(cuda, cr_launches, cutoff):
    # K4's custom op under torch.func.vmap folds the lanes into one
    # (B, N) launch: the same bits as a direct (B, N) call, one launch.
    from admm_tpu_torch.ops import tridiag

    sol = CyclicReductionSolver.from_tridiag(*tv_system(5000, 1.0), dense_cutoff=cutoff,
                                             device=cuda, dtype=torch.float32)
    N = sol.alphas.shape[1]
    bb = torch.randn((16, N), generator=torch.Generator().manual_seed(4)).to(cuda)
    direct = cr_solve(bb, sol)
    assert cr_launches() == 1
    lanes = torch.func.vmap(lambda b: cr_solve(b[None], sol)[0])(bb)
    assert cr_launches() == 2
    assert torch.equal(lanes, direct)
    assert torch.equal(tridiag._cr_solve_op(bb, id(sol)), direct)


# ---- slice 9: K4's gradient rules, the kernels' autograd guard, the
# implicit solvers on the card.

@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("cutoff", [None, 63, 1023])
@pytest.mark.parametrize("system", [_tv_system, _random_system])
def test_cr_backward_and_tangent_go_through_the_kernel(cuda, cr_launches, dtype, cutoff, system):
    # The VJP is a kernel solve of the transposed system and the tangent a
    # kernel solve of the system: the plain version's bits on the same
    # solvers, one launch each, and autograd through the plain version
    # within rounding.
    from admm_tpu_torch.ops.tridiag import cr_solve_op

    sol = CyclicReductionSolver.from_tridiag(*system(3000), dense_cutoff=cutoff, device=cuda,
                                             dtype=dtype)
    N = sol.alphas.shape[1]
    gen = torch.Generator().manual_seed(7)
    bb, g, bdot = (torch.randn((3, N), generator=gen, dtype=dtype).to(cuda) for _ in range(3))
    _, pull = torch.func.vjp(lambda b: cr_solve_op(b, sol), bb)
    base = cr_launches()
    got = pull(g)[0]
    assert cr_launches() == base + 1
    assert torch.equal(got, _cr_solve_torch(g, sol.transposed()))
    _, plain_pull = torch.func.vjp(lambda b: _cr_solve_torch(b, sol), bb)
    ref = plain_pull(g)[0]
    tol = 1e-5 if dtype == torch.float32 else 1e-12
    assert float((got - ref).abs().max()) <= tol * float(ref.abs().max())
    base = cr_launches()
    _, tangent = torch.func.jvp(lambda b: cr_solve_op(b, sol), (bb,), (bdot,))
    assert cr_launches() == base + 2  # the primal and its tangent
    assert torch.equal(tangent, _cr_solve_torch(bdot, sol))
    assert float(tangent.abs().max()) > 0


def test_kernel_wrappers_refuse_autograd_on_gpu(cuda, launches, tail_launches, k2_launches):
    # A ctypes launch would return a result without a grad_fn: each
    # wrapper without rules for an operand raises instead, before launching.
    # K2 differentiates b through its rules (test_k2_backward_and_tangent_*)
    # and refuses a traced E or Dt.
    gen = torch.Generator().manual_seed(8)
    x, u = (torch.randn(64, generator=gen).to(cuda) for _ in range(2))
    t = torch.tensor(0.3, device=cuda)
    with pytest.raises(NotImplementedError, match="derivative rules"):
        fused_soft_threshold_dual(x.requires_grad_(), u, t)
    with pytest.raises(NotImplementedError, match="derivative rules"):
        torch.func.grad(lambda a: fused_soft_threshold_dual(a, u, t)[0].sum())(x.detach())
    E = aligned_rows(torch.randn((16, 64), generator=gen).to(cuda))
    Dt = aligned_rows(torch.randn((64, 16), generator=gen).to(cuda))
    b = torch.randn(64, generator=gen).to(cuda)
    with pytest.raises(NotImplementedError, match="for E and Dt"):
        gemv_pair(b, E.requires_grad_(), Dt)
    with pytest.raises(NotImplementedError, match="for E and Dt"):
        torch.func.grad(lambda ee: gemv_pair(b, ee, Dt).sum())(E.detach())
    z = torch.zeros(64, device=cuda)
    with pytest.raises(NotImplementedError, match="derivative rules"):
        resident_lasso(z, z.clone(), b.requires_grad_(), E.detach(), Dt, 1.0, 0.1, 1)
    assert launches() == 0 and tail_launches() == 0 and k2_launches() == 0
    # Without gradients they launch as before.
    with torch.no_grad():
        gemv_pair(b, E, Dt)
    assert k2_launches() == 1


def test_tv_lanes_backward_is_one_k4_launch_per_adjoint_step(cuda, cr_launches):
    # make_implicit_batch_solver on tv_batch's lanes (hybrid form): every
    # solve of the backward is one K4 launch of all lanes, and the lanes'
    # gradients equal the same solves' on the CPU.
    from admm_tpu_torch import make_implicit_batch_solver
    from admm_tpu_torch.linop import DiffOp
    from admm_tpu_torch.models.totalvariation import make_prox_ops

    n, B = 3000, 4
    rng = np.random.default_rng(9)
    W = np.cumsum(rng.standard_normal((B, n)), axis=1)
    S = W + 0.5 * rng.standard_normal((B, n))
    lams = np.geomspace(0.5, 2.0, B)
    cfg = ADMMConfig(maxiters=3000, abstol=1e-10, reltol=1e-10, unroll="auto")
    grads = []
    for dev in (cuda, torch.device("cpu")):
        St, Wt, lt = (torch.from_numpy(a).to(dev) for a in (S, W, lams))
        pf, pg, _, data, _ = make_prox_ops(St[0], 1.0, cfg, solver="cr", batched=True)
        batch = make_implicit_batch_solver(pf, pg, cfg, mapped={"s", "lam"}, A=DiffOp(n),
                                           nA=n, nB=n, vjp_tol=1e-10)
        loss = lambda l: torch.sum(torch.mean(  # noqa: E731
            (batch(dict(data, s=St, lam=l))[0] - Wt) ** 2, dim=1))
        _, pull = torch.func.vjp(loss, lt)
        before = cr_launches()
        grads.append(pull(torch.ones((), dtype=lt.dtype, device=dev))[0].cpu())
        if dev.type == "cuda":
            assert cr_launches() - before == batch.stats["applies"] + 2
    np.testing.assert_allclose(grads[0].numpy(), grads[1].numpy(), rtol=1e-9)


def test_implicit_solver_on_gpu_matches_the_cpu(cuda):
    # The serial solver (both modes) on the headline-style lasso proxes, no
    # kernel on the path: the card's gradient equals the CPU's in f64.
    from admm_tpu_torch import make_implicit_solver
    from admm_tpu_torch.models.lasso import make_prox_ops

    rng = np.random.default_rng(10)
    D, s = rng.standard_normal((40, 120)), rng.standard_normal(40)
    cfg = ADMMConfig(maxiters=4000, abstol=1e-11, reltol=1e-11, unroll="auto")
    got = {}
    for dev in (cuda, torch.device("cpu")):
        pf, pg, _, data = make_prox_ops(*(torch.from_numpy(a).to(dev) for a in (D, s)), 0.3, cfg)
        for mode in ("vjp", "jvp"):
            solve = make_implicit_solver(pf, pg, cfg, nA=120, nB=120, m=120, mode=mode)
            f = lambda l: torch.sum(solve(dict(data, lam=l))[0] ** 2)  # noqa: E731
            lam = data["lam"]
            got[dev.type, mode] = float(torch.func.grad(f)(lam) if mode == "vjp" else
                                        torch.func.jvp(f, (lam,), (torch.ones_like(lam),))[1])
    for mode in ("vjp", "jvp"):
        np.testing.assert_allclose(got["cuda", mode], got["cpu", mode], rtol=1e-9)


# ---- slice 11b: K2's rules, the lanes' table, the matrix command ---------


def _bf16_fat(dev, m=300, n=1000, seed=11):
    rng = np.random.default_rng(seed)
    D = torch.from_numpy((rng.standard_normal((m, n)) / np.sqrt(m)).astype(np.float32)).to(dev)
    fat = FatShiftSolver.from_matrix(D, 1.0, torch.bfloat16)
    b, g = (torch.from_numpy(rng.standard_normal(n).astype(np.float32)).to(dev)
            for _ in range(2))
    return fat, b, g


def test_k2_backward_and_tangent_go_through_the_kernel(cuda, k2_launches):
    # The backward is one K2 launch of the transposed pair, the tangent one
    # of the pair itself; each within K2's forward bar (1e-3 ||x||_inf at
    # K = 1 in bf16) of the plain version on the same operands.
    fat, b, g = _bf16_fat(cuda)
    _, pull = torch.func.vjp(fat.solve, b)
    base = k2_launches()
    got = pull(g)[0]
    assert k2_launches() == base + 1
    T = fat.pair.transposed()
    ref = g / fat.rho0 + _gemv_pair_torch(-g / (fat.rho0 * fat.rho0), T.E, T.Dt, 1, True)
    assert float((got - ref).abs().max()) <= 1e-3 * float(ref.abs().max())
    base = k2_launches()
    _, tangent = torch.func.jvp(fat.solve, (b,), (g,))
    assert k2_launches() == base + 2  # the primal and its tangent
    ref = g / fat.rho0 - _gemv_pair_torch(g, fat.E, fat.Dt) / (fat.rho0 * fat.rho0)
    assert float((tangent - ref).abs().max()) <= 1e-3 * float(ref.abs().max())
    # torch.autograd takes the same rule.
    bb = b.clone().requires_grad_()
    (ga,) = torch.autograd.grad(fat.solve(bb), bb, g)
    assert float((ga - got).abs().max()) <= 1e-6 * float(got.abs().max())


def test_bf16_lasso_hypergradient_runs_on_gpu(cuda, k2_launches):
    # The bf16-stream lasso differentiates on the card (K2 in the forward
    # and in every adjoint step) and lands within 2e-2 of the f32 gradient.
    from admm_tpu_torch import make_implicit_solver
    from admm_tpu_torch.models.lasso import make_prox_ops

    D, s, lam = make_problem(smoke=True)[:3]
    n = D.shape[1]
    cfg = ADMMConfig(maxiters=3000, abstol=1e-6, reltol=1e-6, unroll="auto")
    grads = {}
    for sd in (None, torch.bfloat16):
        pf, pg, _, data = make_prox_ops(*(torch.from_numpy(a).to(cuda, torch.float32)
                                          for a in (D, s)), lam, cfg, stream_dtype=sd)
        # The bf16 adjoint's residual floors near 4e-3 relative (its J
        # applications round to bf16), so it stops at 1e-2.
        solve = make_implicit_solver(pf, pg, cfg, nA=n, nB=n, m=n,
                                     vjp_tol=1e-5 if sd is None else 1e-2)
        base = k2_launches()
        grads[sd] = float(torch.func.grad(
            lambda l: torch.sum(solve(dict(data, lam=l))[0] ** 2))(data["lam"]))
        assert (k2_launches() > base) == (sd is not None)
    assert np.isfinite(grads[torch.bfloat16])
    assert abs(grads[torch.bfloat16] - grads[None]) <= 2e-2 * abs(grads[None])


def test_lanes_table_on_gpu(cuda, capfd):
    # The lanes' quiet=False rows on the card: the CPU's rows (lanes that
    # stop at different steps), values within f64 rounding.
    rng = np.random.default_rng(0)
    D = rng.standard_normal((12, 24))
    S = rng.standard_normal((3, 12))
    S[1] *= 5
    cfg = ADMMConfig(maxiters=400, abstol=1e-3, reltol=1e-2, quiet=False, unroll=4)
    from admm_tpu_torch import lasso_batch

    rows = {}
    for dev in ("cpu", cuda):
        res = lasso_batch(D, S, 0.5, cfg, device=dev)
        rows[str(dev)] = capfd.readouterr().out.splitlines()
        assert res.steps.tolist() == [20, 43, 24]
    got, ref = rows[str(cuda)], rows["cpu"]
    assert len(got) == len(ref) == 3 * 44
    assert [r.split("\t")[0] for r in got] == [r.split("\t")[0] for r in ref]
    num = lambda rs: np.array([[float(f.split()[1]) for f in r.split("\t")[1:]]  # noqa: E731
                               for r in rs])
    np.testing.assert_allclose(num(got), num(ref), rtol=1e-3)


@pytest.mark.parametrize("row,kernel", [("lasso_fat_f32_fusedkernel", "K1b"),
                                        ("totalvariation_cr", "K4")])
def test_cli_matrix_rows_on_gpu(cuda, tmp_path, row, kernel, tail_launches, cr_launches):
    # python -m admm_tpu_torch matrix on one K1b row and the K4 rows: the
    # row's kernel runs, every row has its bound, the rates are finite.
    import json

    from admm_tpu_torch.__main__ import main

    out = tmp_path / "m.json"
    assert main(["matrix", "--rows", row, "--steps", "200", "--out", str(out)]) == 0
    doc = json.loads(out.read_text())
    assert doc["platform"] == "gpu" and doc["nvidia_smi"]
    rows = doc["timing"]
    assert rows and all(r["solver"] == row and r["iters"] == 200 for r in rows)
    for r in rows:
        assert "valid" not in r and r["bound_ms_per_iter"] > 0 and r["iters_per_sec"] > 0
        assert ("pct_of_roofline" in r) != ("roofline_note" in r)
    assert (tail_launches() if kernel == "K1b" else cr_launches()) >= 200


# ---- slice 10a: the distributed layer, W shards stacked on the card -------


def _parallel_solvers():
    """Every runner of admm_tpu_torch.parallel at a small size: {name:
    (solve(dtype, cfg, device), the iterate held against f64, matrix.py's
    f32 bar, cuSOLVER reads per sub-step)}, on numpy inputs from one seed.
    The eigh local proxes (covsel 'eigh', the SDP's eigh z-prox) read
    cuSOLVER's info back once a call (torch.linalg.eigh has no _ex form)."""
    import admm_tpu_torch.parallel as TP

    rng = np.random.default_rng(40)
    D, s = rng.standard_normal((203, 24)), rng.standard_normal(203)
    lam = 0.1 * float(np.max(np.abs(D.T @ s)))
    ell = np.sign(D @ rng.standard_normal(24) + 0.3 * rng.standard_normal(203))
    S = np.stack([s + 0.1 * k for k in range(4)])
    Dcov = rng.standard_normal((256, 16))
    As, bs = rng.standard_normal((8, 20, 10)), rng.standard_normal((8, 20))
    C, A, b, *_ = random_sdp_instance(10, 12, 3, rng)
    P = rng.standard_normal((64, 64))
    PtPinv = np.linalg.inv(P.T @ P + np.eye(64))
    q = P.T @ rng.standard_normal(64)
    mesh = lambda dev: TP.make_mesh(8, device=dev)  # noqa: E731
    mesh2 = lambda dev: TP.make_mesh2d(2, 4, device=dev)  # noqa: E731

    def sliced(dt, cfg, dev):
        M, qq = (torch.as_tensor(v.astype(dt), device=dev) for v in (PtPinv, q))

        def pf_slice(x, z, u, rho, k):
            return M[8 * k:8 * k + 8] @ (qq + rho * (z - u))

        def pg_slice(x, z, u, rho, k):
            return soft_threshold_slice(x + u, k, 0.5 / rho)

        return admm(pf_slice, pg_slice, cfg, A=1.0, B=-1.0, c=0.0, m=64, parallel="both",
                    slices=(8, 8), mesh=mesh(dev), dtype=M.dtype, device=dev)

    return {
        "consensus_lasso": (lambda dt, cfg, dev: TP.consensus_lasso(
            D.astype(dt), s.astype(dt), lam, cfg, mesh=mesh(dev)), "zopt", 1e-3, 0),
        "consensus_lasso_rbadaptive": (lambda dt, cfg, dev: TP.consensus_lasso(
            D.astype(dt), s.astype(dt), lam, dataclasses.replace(cfg, rbadaptive=True),
            mesh=mesh(dev)), "zopt", 1e-3, 0),
        "consensus_lasso_anderson": (lambda dt, cfg, dev: TP.consensus_lasso(
            D.astype(dt), s.astype(dt), lam, dataclasses.replace(cfg, anderson=5),
            mesh=mesh(dev)), "zopt", 1e-3, 0),
        "consensus_elasticnet": (lambda dt, cfg, dev: TP.consensus_elasticnet(
            D.astype(dt), s.astype(dt), lam, 0.5, cfg, mesh=mesh(dev)), "zopt", 1e-3, 0),
        "consensus_logreg_newton": (lambda dt, cfg, dev: TP.consensus_logreg(
            D.astype(dt), ell.astype(dt), 0.5, cfg, mesh=mesh(dev), newton_steps=8),
            "zopt", 5e-3, 0),
        "consensus_logreg_cg": (lambda dt, cfg, dev: TP.consensus_logreg(
            D.astype(dt), ell.astype(dt), 0.5, cfg, mesh=mesh(dev), inner="newton_cg",
            newton_steps=8, cg_steps=8), "zopt", 5e-3, 0),
        "consensus_covsel_eigh": (lambda dt, cfg, dev: TP.consensus_covsel(
            Dcov.astype(dt), 0.2, cfg, mesh=mesh(dev)), "zopt", 1e-3, 1),
        "consensus_covsel_ns": (lambda dt, cfg, dev: TP.consensus_covsel(
            Dcov.astype(dt), 0.2, cfg, mesh=mesh(dev), prox_method="ns"), "zopt", 1e-3, 0),
        "consensus_lasso_batch": (lambda dt, cfg, dev: TP.consensus_lasso_batch(
            D.astype(dt), S.astype(dt), lam, cfg, mesh=mesh2(dev)), "zopt", 1e-3, 0),
        "consensus_covsel_batch_ns": (lambda dt, cfg, dev: TP.consensus_covsel_batch(
            np.stack([Dcov, Dcov[::-1]]).astype(dt), 0.2, cfg, mesh=mesh2(dev),
            prox_method="ns"), "zopt", 1e-3, 0),
        "linearsvm_sharded": (lambda dt, cfg, dev: TP.linearsvm_sharded(
            D.astype(dt), ell.astype(dt), 1.0, cfg, mesh=mesh(dev)), "xopt", 0.05, 0),
        "svm_batch_sharded": (lambda dt, cfg, dev: TP.svm_batch_sharded(
            D.astype(dt), np.stack([ell, -ell]).astype(dt), 1.0, cfg, mesh=mesh2(dev),
            nshards=8), "xopt", 0.05, 0),
        "exchange_quadratic": (lambda dt, cfg, dev: TP.exchange_quadratic(
            As.astype(dt), bs.astype(dt), cfg, mesh=mesh(dev)), "xopt", 1e-3, 0),
        "sdp_sharded_ns": (lambda dt, cfg, dev: TP.sdp_sharded(
            C.astype(dt), A.astype(dt), b.astype(dt), cfg, mesh=mesh(dev), prox_method="ns",
            ns_iters=30), "zopt", 1e-3, 0),
        "sdp_sharded_eigh": (lambda dt, cfg, dev: TP.sdp_sharded(
            C.astype(dt), A.astype(dt), b.astype(dt), cfg, mesh=mesh(dev)), "zopt", 1e-3, 1),
        "sliced_both": (sliced, "xopt", 1e-3, 0),
    }


def soft_threshold_slice(v, k, t):
    seg = v[8 * k:8 * k + 8]
    return torch.sign(seg) * torch.clamp_min(seg.abs() - t, 0.0)


@pytest.mark.parametrize("name", sorted(_parallel_solvers()))
def test_parallel_chunk_reads_nothing_back(cuda, monkeypatch, launches, tail_launches,
                                           k2_launches, cr_launches, name):
    # One chunk of 8 sub-steps in f32: one read of the stop flag after
    # them, no synchronising call inside them but the eigh proxes' one
    # cuSOLVER read a call, and no K1-K4 launch (a per-shard solve is a
    # batched GEMV; the z-steps are soft_threshold on the aggregate).
    solve, _, _, per_step = _parallel_solvers()[name]
    K = 8
    res, syncs, reads = _chunk_syncs(monkeypatch, lambda: solve(
        np.float32, ADMMConfig(maxiters=K, unroll=K, domaxiters=True), cuda), K)
    assert reads == [1]
    if per_step:  # one eigh call a sub-step, as test_eigh_chunk_syncs_once_a_sub_step
        assert syncs == [syncs[0]] * K and 1 <= syncs[0] <= 2, syncs
    else:
        assert syncs == [0] * K, syncs
    x = res.zopt
    assert x.device.type == "cuda" and torch.isfinite(x).all()
    assert (launches(), tail_launches(), k2_launches(), cr_launches()) == (0, 0, 0, 0)


@pytest.mark.parametrize("name", sorted(_parallel_solvers()))
def test_parallel_f32_on_gpu_within_its_bar(cuda, name):
    # f32 against f64 on the card, both at admm_tpu's oracle settings, to
    # matrix.py's f32 bar of the family (relative error of the iterate).
    solve, key, bar, _ = _parallel_solvers()[name]
    cfg = ADMMConfig(maxiters=20000, abstol=1e-7, reltol=1e-6, stallwindow=100, unroll="auto")
    r32, r64 = solve(np.float32, cfg, cuda), solve(np.float64, cfg, cuda)
    a32, a64 = getattr(r32, key), getattr(r64, key)
    assert a32.dtype == torch.float32 and a32.device.type == "cuda"
    err = float(torch.linalg.norm(a32.double() - a64) / torch.linalg.norm(a64))
    assert err <= bar, err


@pytest.mark.parametrize("name", sorted(_parallel_solvers()))
def test_parallel_on_gpu_matches_the_cpu(cuda, name):
    # f64 on both devices: equal steps, the iterate within a parity bar.
    solve, key, _, _ = _parallel_solvers()[name]
    cfg = ADMMConfig(maxiters=300, unroll=4)
    res, cpu = solve(np.float64, cfg, cuda), solve(np.float64, cfg, "cpu")
    steps = lambda r: r.steps.tolist() if torch.is_tensor(r.steps) else r.steps  # noqa: E731
    assert steps(res) == steps(cpu)
    ref = getattr(cpu, key).numpy()
    np.testing.assert_allclose(getattr(res, key).cpu().numpy(), ref, rtol=1e-9,
                               atol=1e-9 * np.max(np.abs(ref)))


# ---- slice 10b: the shard axis over processes, on the card ----------------


def _consensus_instance(rows=4096, cols=256, seed=41):
    rng = np.random.default_rng(seed)
    D = rng.standard_normal((rows, cols)).astype(np.float32)
    s = rng.standard_normal(rows).astype(np.float32)
    return D, s, 0.1 * float(np.max(np.abs(D.T @ s)))


def test_world1_nccl_consensus_equals_stacked_bit_for_bit(cuda, tmp_path):
    """A one-rank NCCL group (the group's code path: every shard-axis
    reduction one all_reduce, the results one all_gather) computes what
    the stacked mesh computes on the card, bit for bit: steps, zopt, the
    per-shard state and every history; 2 collectives a step."""
    import admm_tpu_torch.parallel as TP
    from admm_tpu_torch.parallel import multihost

    D, s, lam = _consensus_instance()
    cfg = ADMMConfig(maxiters=300)
    ref = TP.consensus_lasso(D, s, lam, cfg, mesh=TP.make_mesh(8, device=cuda))
    assert multihost.initialize_cluster("file://" + str(tmp_path / "pg"), 1, 0,
                                        backend="nccl", timeout=120) == 1
    try:
        mesh = TP.make_mesh(8, group=TP.global_mesh().group)
        assert mesh.device.type == "cuda"
        res = TP.consensus_lasso(D, s, lam, cfg, mesh=mesh)
        torch.cuda.synchronize()
    finally:
        multihost.shutdown()
    assert res.steps == ref.steps
    for name in ("zopt", "xopt", "uopt"):
        assert torch.equal(getattr(res, name), getattr(ref, name)), name
    assert torch.equal(res.extra["xi"], ref.extra["xi"])
    for key, h in ref.hist.items():
        assert torch.equal(res.hist[key].nan_to_num(7.0), h.nan_to_num(7.0)), key
    assert mesh.stats["calls"] == {"all_reduce": 2 * res.steps, "all_gather": 1}


def test_two_gloo_ranks_share_the_card(cuda, tmp_path):
    """Two gloo ranks on the one card (CUDA tensors through gloo), each
    its block of 4 of 8 shards, f64: the same steps and history bits on
    both ranks, and the stacked run's steps and solution (1e-9)."""
    import admm_tpu_torch.parallel as TP

    from _torch_ranks import check, run_ranks

    rng = np.random.default_rng(42)
    D, s = rng.standard_normal((509, 24)), rng.standard_normal(509)
    ref = TP.consensus_lasso(D, s, 0.5, ADMMConfig(maxiters=3000),
                             mesh=TP.make_mesh(8, device=cuda))
    rc, init, out, res = run_ranks('''
        from admm_tpu_torch import ADMMConfig
        from admm_tpu_torch.parallel import consensus_lasso, make_mesh
        assert mesh.device.type == "cuda"
        rng = np.random.default_rng(42)
        D, s = rng.standard_normal((509, 24)), rng.standard_normal(509)
        r = consensus_lasso(torch.as_tensor(D, device=mesh.device),
                            torch.as_tensor(s, device=mesh.device), 0.5,
                            ADMMConfig(maxiters=3000), mesh=make_mesh(8, group=mesh.group))
        save(steps=r.steps, zopt=r.zopt, pnorm=r.hist["pnorm"])
    ''', tmp_path, join=dict(backend="gloo"))
    check(rc, init, out)
    r0, r1 = res
    assert int(r0["steps"]) == int(r1["steps"]) == ref.steps
    assert np.array_equal(r0["pnorm"].view(np.int64), r1["pnorm"].view(np.int64))
    want = ref.zopt.cpu().numpy()
    np.testing.assert_allclose(r0["zopt"], want, rtol=1e-9, atol=1e-9 * np.abs(want).max())


def test_initialize_cluster_refuses_nccl_ranks_sharing_a_card(cuda, tmp_path):
    """A rank whose local rank has no card of its own under NCCL raises
    and names backend="gloo"; nothing is joined."""
    from admm_tpu_torch.parallel import multihost

    count = torch.cuda.device_count()
    with pytest.raises(ValueError, match='backend="gloo"'):
        multihost.initialize_cluster("file://" + str(tmp_path / "pg"), count + 1, count,
                                     backend="nccl")
    assert not torch.distributed.is_initialized()


@pytest.mark.parametrize("lanes", [1, 8])
def test_vmapped_reduction_is_one_nccl_all_reduce(cuda, tmp_path, monkeypatch, lanes):
    """Mesh.psum and Mesh.pmean under torch.func.vmap over a one-rank NCCL
    group: one all_reduce of the whole (B, ...) CUDA payload a call,
    counted once, the stacked values bit for bit."""
    import torch.distributed as dist

    import admm_tpu_torch.parallel as TP
    from admm_tpu_torch.parallel import multihost

    assert multihost.initialize_cluster("file://" + str(tmp_path / "pg"), 1, 0,
                                        backend="nccl", timeout=120) == 1
    calls = []
    real = dist.all_reduce

    def spy(t, *a, **kw):
        calls.append((tuple(t.shape), t.device.type))
        return real(t, *a, **kw)

    monkeypatch.setattr(dist, "all_reduce", spy)
    try:
        mesh = TP.make_mesh(4, group=TP.global_mesh().group)
        x = torch.randn(lanes, 4, 3, dtype=torch.float64, device=cuda)
        xbar, a = torch.func.vmap(lambda xi: (mesh.pmean(xi), mesh.psum(torch.sum(xi))))(x)
        torch.cuda.synchronize()
        stats = mesh.reset_stats()
    finally:
        multihost.shutdown()
    assert calls == [((lanes, 3), "cuda"), ((lanes, 1), "cuda")]
    assert stats["calls"] == {"all_reduce": 2}
    assert torch.equal(xbar, x.mean(dim=1)) and torch.equal(a, x.sum(dim=(1, 2)))


def test_lanes_over_two_gloo_ranks_on_the_card(cuda, tmp_path):
    """consensus_lasso_batch on make_mesh2d(1, 8) over two gloo ranks on
    the card (each rank 4 of every lane's 8 shards, CUDA tensors through
    gloo), f64: the same bits on both ranks, the stacked steps, 1e-10."""
    import admm_tpu_torch.parallel as TP

    from _torch_ranks import check, run_ranks

    rng = np.random.default_rng(5)
    D, S = rng.standard_normal((64, 10)), rng.standard_normal((4, 64))
    lams = np.geomspace(0.05, 0.4, 4)
    ref = TP.consensus_lasso_batch(D, S, lams, ADMMConfig(maxiters=500),
                                   mesh=TP.make_mesh2d(1, 8, device=cuda))
    rc, init, out, res = run_ranks('''
        from admm_tpu_torch import ADMMConfig
        from admm_tpu_torch.parallel import consensus_lasso_batch, make_mesh2d
        rng = np.random.default_rng(5)
        D, S = rng.standard_normal((64, 10)), rng.standard_normal((4, 64))
        m = make_mesh2d(1, 8, group=mesh.group)
        assert m.device.type == "cuda" and m.span == 2
        r = consensus_lasso_batch(D, S, np.geomspace(0.05, 0.4, 4), ADMMConfig(maxiters=500),
                                  mesh=m)
        save(steps=r.steps, zopt=r.zopt, xi=r.extra["xi"])
    ''', tmp_path, join=dict(backend="gloo"))
    check(rc, init, out)
    r0, r1 = res
    for key in r0:
        assert r0[key].tobytes() == r1[key].tobytes(), key
    assert r0["steps"].tolist() == ref.steps.tolist()
    for key, want in (("zopt", ref.zopt), ("xi", ref.extra["xi"])):
        want = want.cpu().numpy()
        np.testing.assert_allclose(r0[key], want, rtol=1e-10, atol=1e-10 * np.abs(want).max())


def test_vmap_of_grad_over_the_serial_tv_solve_goes_through_k4(cuda, cr_launches):
    """torch.func.vmap(torch.func.grad(loss)) over the serial implicit TV
    solve (the hybrid form), f64: each lane equals the serial gradient
    (1e-8), and every solve of its backward is one K4 launch of all
    lanes."""
    from admm_tpu_torch import make_implicit_solver
    from admm_tpu_torch.linop import DiffOp
    from admm_tpu_torch.models.totalvariation import make_prox_ops

    n = 4096
    rng = np.random.default_rng(3)
    truth = np.repeat(rng.standard_normal(n // 64), 64)
    s = torch.as_tensor(truth + 0.5 * rng.standard_normal(n), device=cuda)
    cfg = ADMMConfig(maxiters=3000, abstol=1e-10, reltol=1e-10)
    pf, pg, _, data, _ = make_prox_ops(s, 0.5, cfg, solver="cr", batched=True)
    solve = make_implicit_solver(pf, pg, cfg, A=DiffOp(n), nA=n, nB=n, vjp_tol=1e-10)
    t = torch.as_tensor(truth, device=cuda)

    def loss(lam):
        return torch.mean((solve(dict(data, lam=lam))[0] - t) ** 2)

    lams = torch.tensor([0.3, 0.5, 0.8], dtype=torch.float64, device=cuda)
    with torch.no_grad():
        torch.func.vmap(loss)(lams)
    forward = cr_launches()
    g = torch.func.vmap(torch.func.grad(loss))(lams)
    torch.cuda.synchronize()
    assert cr_launches() - 2 * forward == solve.stats["applies"] + 2
    for i in range(3):
        gi = torch.func.grad(loss)(lams[i])
        np.testing.assert_allclose(float(g[i]), float(gi), rtol=1e-8)


def test_cr_packed_on_the_card_equals_the_cpu(cuda):
    """solver='cr_packed' (plain PyTorch, no kernel) on the card in f64:
    one solve equals the CPU's bit for bit; a TV run takes the CPU's steps
    and lands within 1e-10 of it (the engine's norms sum in another
    order)."""
    from admm_tpu_torch.ops.tridiag import PackedCyclicReductionSolver

    n = 70000
    b = np.random.default_rng(1).standard_normal(n)
    sols = [PackedCyclicReductionSolver.from_tridiag(*tv_system(n, 1.0), device=d)
            for d in (cuda, "cpu")]
    x_gpu = sols[0].solve(torch.as_tensor(b, device=cuda))
    x_cpu = sols[1].solve(torch.as_tensor(b))
    assert torch.equal(x_gpu.cpu(), x_cpu)
    rng = np.random.default_rng(7)
    sig = np.repeat(rng.standard_normal(300), 64) + 0.3 * rng.standard_normal(300 * 64)
    cfg = ADMMConfig(maxiters=2000)
    r_gpu = totalvariation(sig, 0.5, cfg, solver="cr_packed", device=cuda)
    r_cpu = totalvariation(sig, 0.5, cfg, solver="cr_packed", device="cpu")
    assert r_gpu.steps == r_cpu.steps
    np.testing.assert_allclose(r_gpu.xopt.cpu().numpy(), r_cpu.xopt.numpy(), rtol=1e-10,
                               atol=1e-10 * float(r_cpu.xopt.abs().max()))
