"""Parity of the port's cyclic-reduction solver (admm_tpu_torch/ops/tridiag.py)
against admm_tpu's, and of its plain b-phase against admm_tpu's Pallas
kernel K4 (experiments/pallas_cr_kernel.py) run in interpret mode.

The CUDA kernel itself runs only on a CUDA device; its cases are in
tests/test_torch_gpu.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from admm_tpu.ops.tridiag import CyclicReductionSolver as JaxCR
from admm_tpu_torch.models.totalvariation import tv_system
from admm_tpu_torch.ops.tridiag import CyclicReductionSolver, _cr_solve_torch, cr_solve

torch.set_num_threads(1)

STACKS = ("alphas", "betas", "a_lv", "c_lv", "d_lv", "masks_f", "masks_b")
MASKED = [(n, None) for n in (1, 2, 3, 7, 64, 255, 1000)]
HYBRID = [(5000, 1023), (5000, 63), (300, 1023), (130, 7)]


def _random_system(n, seed):
    # tests/test_tridiag.py's diagonally dominant generator.
    rng = np.random.default_rng(seed)
    dl = np.r_[0.0, rng.standard_normal(n - 1)]
    du = np.r_[rng.standard_normal(n - 1), 0.0]
    d = 4.0 + np.abs(rng.standard_normal(n))
    return dl, d, du


def _tv_system(n, rho=1.0):
    return tv_system(n, rho)


@pytest.mark.parametrize("n,cutoff", MASKED + HYBRID)
def test_from_tridiag_stacks_equal_jax(n, cutoff):
    args = _random_system(n, seed=n)
    j = JaxCR.from_tridiag(*args, dense_cutoff=cutoff)
    t = CyclicReductionSolver.from_tridiag(*args, dense_cutoff=cutoff)
    # The same NumPy f64 precompute on both sides: equal bit for bit.
    for name in STACKS:
        got, ref = getattr(t, name), np.asarray(getattr(j, name))
        assert got.dtype == (torch.bool if name.startswith("masks") else torch.float64)
        np.testing.assert_array_equal(got.numpy(), ref)
    assert (t.n, t.cut_stride) == (j.n, j.cut_stride)
    assert (t.Tinv is None) == (j.Tinv is None) == (cutoff is None)
    if cutoff is not None:
        np.testing.assert_array_equal(t.Tinv.numpy(), np.asarray(j.Tinv))


def test_from_tridiag_stores_in_the_solve_dtype():
    args = _tv_system(300)
    t64 = CyclicReductionSolver.from_tridiag(*args, dense_cutoff=63)
    t32 = CyclicReductionSolver.from_tridiag(*args, dense_cutoff=63, dtype=torch.float32)
    for name in ("alphas", "betas", "a_lv", "c_lv", "d_lv", "Tinv"):
        got = getattr(t32, name)
        assert got.dtype == torch.float32
        # One round to nearest from the f64 precompute, as .astype does.
        assert torch.equal(got, getattr(t64, name).float())


@pytest.mark.parametrize("n,cutoff", MASKED + HYBRID)
def test_solve_matches_jax(n, cutoff):
    args = _random_system(n, seed=n + 1)
    b = np.random.default_rng(n).standard_normal(n)
    j = JaxCR.from_tridiag(*args, dense_cutoff=cutoff)
    t = CyclicReductionSolver.from_tridiag(*args, dense_cutoff=cutoff)
    x = t.solve(torch.from_numpy(b))
    assert x.shape == (n,) and x.dtype == torch.float64
    np.testing.assert_allclose(x.numpy(), np.asarray(j.solve(jnp.asarray(b))),
                               rtol=1e-12, atol=1e-14)
    T = np.diag(args[1])
    if n > 1:
        T += np.diag(args[0][1:], -1) + np.diag(args[2][:-1], 1)
    np.testing.assert_allclose(x.numpy(), np.linalg.solve(T, b), atol=1e-9)


@pytest.mark.parametrize("n", [7, 255, 1000, 4097])
def test_batched_solve_equals_single_solves(n):
    # Masked levels are elementwise per lane: bit for bit.
    sol = CyclicReductionSolver.from_tridiag(*_tv_system(n, rho=0.7))
    B = torch.from_numpy(np.random.default_rng(3).standard_normal((2, 3, n)))
    X = sol.solve(B)
    assert X.shape == (2, 3, n)
    for idx in np.ndindex(2, 3):
        assert torch.equal(X[idx], sol.solve(B[idx]))


@pytest.mark.parametrize("n,cutoff", HYBRID)
def test_batched_hybrid_solve_matches_single_solves(n, cutoff):
    # The dense tail is one (B, M) x (M, M) product; a BLAS may block a
    # batch of rows differently from a single row, so the lanes agree to
    # the tail's rounding (a few ulps), not bit for bit.
    sol = CyclicReductionSolver.from_tridiag(*_random_system(n, 4), dense_cutoff=cutoff)
    B = torch.from_numpy(np.random.default_rng(4).standard_normal((5, n)))
    X = sol.solve(B)
    for i in range(5):
        np.testing.assert_allclose(X[i].numpy(), sol.solve(B[i]).numpy(),
                                   rtol=1e-13, atol=1e-14)


@pytest.mark.parametrize("n,lanes", [(300, 8), (1000, 16)])
def test_plain_version_matches_pallas_kernel(n, lanes):
    from experiments.pallas_cr_kernel import build_coeffs, cr_solve_pallas

    args = _tv_system(n)
    coeffs, _, N, Np, L = build_coeffs(*args)
    b = np.random.default_rng(n).standard_normal((lanes, n)).astype(np.float32)
    b2 = jnp.asarray(np.pad(b, ((0, 0), (0, Np - n))))
    ref = np.asarray(cr_solve_pallas(b2, tuple(map(jnp.asarray, coeffs)), L, N,
                                     interpret=True))[:, :n]
    sol = CyclicReductionSolver.from_tridiag(*args, dtype=torch.float32)
    x = sol.solve(torch.from_numpy(b)).numpy()
    # K4 multiplies by precomputed reciprocals of the pivots where the
    # port divides (as admm_tpu's solve does), so the two differ by a
    # few f32 ulps per level; 1e-6 of max|x| is ~8 ulps.
    assert np.max(np.abs(x - ref)) <= 1e-6 * np.max(np.abs(ref))


def test_cr_solve_on_the_cpu_is_the_plain_version(monkeypatch):
    monkeypatch.setattr(cr_solve, "launches", 0)
    sol = CyclicReductionSolver.from_tridiag(*_random_system(100, 5), dense_cutoff=15)
    N = sol.alphas.shape[1]
    bb = torch.from_numpy(np.random.default_rng(5).standard_normal((3, N)))
    before = bb.clone()
    assert torch.equal(cr_solve(bb, sol), _cr_solve_torch(bb, sol))
    assert torch.equal(bb, before)  # the input is not modified
    assert cr_solve.launches == 0   # the CPU never counts
    x = sol.solve(bb[:, :100], plain=True)
    assert torch.equal(x, sol.solve(bb[:, :100]))


def test_cr_solve_refuses_what_it_does_not_take():
    sol = CyclicReductionSolver.from_tridiag(*_random_system(100, 6))
    N = sol.alphas.shape[1]
    with pytest.raises(ValueError, match=f"\\(B, {N}\\)"):
        cr_solve(torch.zeros(N, dtype=torch.float64), sol)
    with pytest.raises(ValueError, match=f"\\(B, {N}\\)"):
        cr_solve(torch.zeros((1, 100), dtype=torch.float64), sol)
    with pytest.raises(ValueError, match="float32"):
        cr_solve(torch.zeros((1, N), dtype=torch.float32), sol)
