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
from admm_tpu.ops.tridiag import PackedCyclicReductionSolver as JaxPacked
from admm_tpu_torch.models.totalvariation import tv_system
from admm_tpu_torch.ops import tridiag
from admm_tpu_torch.ops.tridiag import (
    CyclicReductionSolver, PackedCyclicReductionSolver, TilePlan, _cr_solve_torch, _tail, compact_stacks, cr_solve,
    level_offsets, tile_plan)

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


@pytest.mark.parametrize("system", [_tv_system, lambda n: _random_system(n, n)])
def test_from_tridiag_stacks_equal_jax_at_the_tv_cells_shape(system):
    # 7 masked levels over 131,071 rows and a 1023-row inverse, as in
    # tests above: torch's recurrence gives NumPy's bits at full length.
    args = system(65536)
    j = JaxCR.from_tridiag(*args, dense_cutoff=1023)
    t = CyclicReductionSolver.from_tridiag(*args, dense_cutoff=1023)
    for name in STACKS:
        np.testing.assert_array_equal(getattr(t, name).numpy(), np.asarray(getattr(j, name)))
    np.testing.assert_array_equal(t.Tinv.numpy(), np.asarray(j.Tinv))


def test_a_cpu_build_counts_no_device_precompute(monkeypatch):
    monkeypatch.setattr(CyclicReductionSolver, "device_precomputes", 0)
    for cutoff in (None, 63):
        sol = CyclicReductionSolver.from_tridiag(*_tv_system(300), dense_cutoff=cutoff)
        assert sol.alphas.device.type == "cpu" and sol._compact is None
    assert CyclicReductionSolver.device_precomputes == 0


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


@pytest.mark.parametrize("n,cutoff", MASKED + HYBRID + [(20000, 1023)])
def test_compact_stacks_are_the_active_entries(n, cutoff):
    sol = CyclicReductionSolver.from_tridiag(*_random_system(n, 7), dense_cutoff=cutoff)
    al, be, a, c, d = compact_stacks(sol)
    k, N = sol.alphas.shape
    # Boolean indexing walks the (k, N) stacks row by row: level after
    # level, active rows in order, which is the kernel's layout.
    for got, full, mask in ((al, sol.alphas, sol.masks_f), (be, sol.betas, sol.masks_f),
                            (a, sol.a_lv, sol.masks_b), (c, sol.c_lv, sol.masks_b),
                            (d, sol.d_lv, sol.masks_b)):
        assert torch.equal(got, full[mask])
    f_off, b_off = level_offsets(N, k)
    assert f_off[-1] == al.numel() and b_off[-1] == a.numel()
    assert np.diff(f_off).tolist() == sol.masks_f.sum(1).tolist()
    assert np.diff(b_off).tolist() == sol.masks_b.sum(1).tolist()
    assert compact_stacks(sol) is compact_stacks(sol)  # built once


def test_tile_plan_at_the_tv_shapes():
    # (1, 65536) hybrid: N = 2^17 - 1, k = 7 levels, stratum stride 128.
    assert tile_plan(131071, 7, True, 4) == TilePlan(512, 127, 256, 766, 256, True)
    # (128, 8192) hybrid: N = 2^14 - 1, k = 4; about TARGET_TILES tiles.
    assert tile_plan(16383, 4, True, 4, lanes=128) == TilePlan(4096, 15, 4, 4126, 256, True)
    # Pure masked: one tile per lane, in shared memory while it fits.
    assert tile_plan(8191, 13, False, 4) == TilePlan(8191, 0, 1, 8191, 1024, True)
    assert tile_plan(32767, 15, False, 4).shared
    assert not tile_plan(32767, 15, False, 8).shared
    # Tiles stay a multiple of the stratum stride and fit shared memory.
    plan = tile_plan(2**22 - 1, 12, True, 8, lanes=1000)
    assert plan.C % 4096 == 0 and plan.shared
    assert tile_plan(2**22 - 1, 12, True, 4)[:3] == (8192, 4095, 512)


def _bits(a):
    return a.view(np.int32 if a.dtype == np.float32 else np.int64)


def _emulate_k4(bb, sol, plan):
    """NumPy emulation of csrc/cr_solve.cu's cr_tile_kernel: every tile of
    ``plan`` of every lane loads its rows and halo, runs its levels on the
    compacted stacks with the kernel's index arithmetic (one level's
    updates at once: they read no row they write), and writes back its own
    rows; the hybrid tail is the same torch call as both solve paths'."""
    al, be, a, c, d = (t.numpy() for t in compact_stacks(sol))
    b = bb.numpy()
    B, N = b.shape
    k, n, dt = sol.alphas.shape[0], sol.n, b.dtype
    f_off, b_off = level_offsets(N, k)
    st = 2**k
    M = (N + 1) // st - 1
    zero = np.zeros((), dt)

    def rows_in(lo, hi, P, q):
        return ((lo - q + P - 1) // P if lo > q else 0,
                (hi - q + P - 1) // P if hi > q else 0)

    def forward(w, lo, hi):
        for l in range(k):
            s = 2**l
            j0, j1 = rows_in(lo, hi, 2 * s, 2 * s - 1)
            j = np.arange(j0, min(j1, ((N + 1) >> (l + 1)) - 1))
            i = (j + 1) * 2 * s - 1
            up = np.where(i - s >= lo, w[np.maximum(i - s - lo, 0)], zero)
            dn = np.where(i + s < hi, w[np.minimum(i + s - lo, hi - lo - 1)], zero)
            w[i - lo] = (w[i - lo] - al[f_off[l] + j] * up) - be[f_off[l] + j] * dn

    def back(w, lo, hi):
        for l in range(k - 1, -1, -1):
            s = 2**l
            j0, j1 = rows_in(lo, hi, 2 * s, s - 1)
            j = np.arange(j0, min(j1, (N + 1) >> (l + 1)))
            i = j * 2 * s + s - 1
            ok = (i >= s) & (i - s >= lo)
            xm = np.where(ok, w[np.maximum(i - s - lo, 0)], zero)
            xp = np.where(i + s < hi, w[np.minimum(i + s - lo, hi - lo - 1)], zero)
            o = b_off[l] + j
            w[i - lo] = ((w[i - lo] - a[o] * xm) - c[o] * xp) / d[o]

    def tiles():
        for lane in range(B):
            for t in range(plan.tiles):
                t0, t1 = t * plan.C, min(t * plan.C + plan.C, N)
                yield lane, t0, t1, max(t0 - plan.R, 0), min(t1 + plan.R, N)

    def padding_zeros(w, lo):
        return lo >= n and not np.any(_bits(w))

    x = np.empty_like(b)
    if sol.Tinv is None:
        for lane, t0, t1, lo, hi in tiles():
            w = b[lane, lo:hi].copy()
            forward(w, lo, hi)
            back(w, lo, hi)
            x[lane, t0:t1] = w[t0 - lo: t1 - lo]
        return x
    work, y = np.empty_like(b), np.empty((B, M), dt)
    for lane, t0, t1, lo, hi in tiles():
        w = b[lane, lo:hi].copy()
        if padding_zeros(w, lo):
            w[:] = 0
        else:
            forward(w, lo, hi)
        work[lane, t0:t1] = w[t0 - lo: t1 - lo]
        j0, j1 = rows_in(t0, t1, st, st - 1)
        j = np.arange(j0, min(j1, M))
        y[lane, j] = w[(j + 1) * st - 1 - lo]
    xs = _tail(sol, torch.from_numpy(y)).numpy()
    for lane, t0, t1, lo, hi in tiles():
        i = np.arange(lo, hi)
        stratum = (i & (st - 1)) == st - 1
        w = np.where(stratum, xs[lane, np.minimum((i + 1) // st - 1, M - 1)],
                     work[lane, lo:hi])
        if padding_zeros(w, lo):
            w[:] = 0
        else:
            back(w, lo, hi)
        x[lane, t0:t1] = w[t0 - lo: t1 - lo]
    return x


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("lanes", [1, 3])
@pytest.mark.parametrize("n,cutoff,rows", [
    (1000, 63, 16),      # N = 1023, k = 4: tiles of 16 rows, halo 15, many tiles
    (1000, 63, 40),      # tiles of 48 rows, the floor rounded up to the stride
    (513, 63, 64),       # N = 1023 with most of the lane padding
    (512, 7, 40),        # N = 1023, k = 7: halo 127, tiles of 128 rows
    (300, 1023, 5),      # k = 0: the tail does it all
    (130, 7, 24),        # tests/test_tridiag.py's deep cut
    (5000, 1023, None),  # the default plan
    (1000, None, None),  # pure masked: one tile per lane
    (7, None, None),
])
def test_tile_emulation_equals_plain_bit_for_bit(monkeypatch, dtype, lanes, n, cutoff, rows):
    if rows is not None:  # a shorter floor than the card's, for more tiles
        monkeypatch.setattr(tridiag, "TILE_ROWS", rows)
    for system in (_tv_system, lambda n: _random_system(n, 11)):
        sol = CyclicReductionSolver.from_tridiag(*system(n), dense_cutoff=cutoff,
                                                 dtype=dtype)
        k, N = sol.alphas.shape
        plan = tile_plan(N, k, cutoff is not None, 4, lanes)
        bb = torch.zeros((lanes, N), dtype=dtype)
        bb[:, :n] = torch.from_numpy(np.random.default_rng(n).standard_normal((lanes, n)))
        got = _emulate_k4(bb, sol, plan)
        ref = _cr_solve_torch(bb, sol).numpy()
        assert np.array_equal(_bits(got), _bits(ref))
        if cutoff is not None and N > n + 2 * plan.R + plan.C:
            # Padding that is not +0 (here -0 and 1) must not take the
            # shortcut: the plain version carries it through the levels.
            bb[0, -1] = -0.0
            bb[-1, n + plan.R + 1] = 1.0
            got = _emulate_k4(bb, sol, plan)
            assert np.array_equal(_bits(got), _bits(_cr_solve_torch(bb, sol).numpy()))


def test_cr_solve_refuses_what_it_does_not_take():
    sol = CyclicReductionSolver.from_tridiag(*_random_system(100, 6))
    N = sol.alphas.shape[1]
    with pytest.raises(ValueError, match=f"\\(B, {N}\\)"):
        cr_solve(torch.zeros(N, dtype=torch.float64), sol)
    with pytest.raises(ValueError, match=f"\\(B, {N}\\)"):
        cr_solve(torch.zeros((1, 100), dtype=torch.float64), sol)
    with pytest.raises(ValueError, match="float32"):
        cr_solve(torch.zeros((1, N), dtype=torch.float32), sol)


PACKED = ("alphas", "betas", "a_lv", "c_lv", "d_lv")


@pytest.mark.parametrize("n", [1, 2, 3, 7, 64, 255, 300, 1000])
def test_packed_solver_matches_jax_and_the_masked_solver(n):
    # The packed layout (admm_tpu's PackedCyclicReductionSolver): the same
    # NumPy f64 precompute, packed stacks equal admm_tpu's bit for bit; the
    # solve against admm_tpu's packed solve (1e-13), the masked solve and
    # the dense solution (1e-10, tests/test_tridiag.py's bars), and with a
    # leading batch dimension against single solves.
    args = _random_system(n, seed=n + 1)
    j = JaxPacked.from_tridiag(*args)
    t = PackedCyclicReductionSolver.from_tridiag(*args)
    for name in PACKED:
        assert len(getattr(t, name)) == len(getattr(j, name))
        for got, ref in zip(getattr(t, name), getattr(j, name)):
            assert got.dtype == torch.float64
            np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    rng = np.random.default_rng(n)
    B = rng.standard_normal((3, n))
    got = t.solve(torch.from_numpy(B))
    want = np.stack([np.asarray(j.solve(jnp.asarray(b))) for b in B])
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-13, atol=1e-14)
    masked = CyclicReductionSolver.from_tridiag(*args).solve(torch.from_numpy(B))
    np.testing.assert_allclose(got.numpy(), masked.numpy(), rtol=1e-10, atol=1e-12)
    dl, d, du = args
    T = np.diag(d) + np.diag(dl[1:], -1) + np.diag(du[:-1], 1)
    np.testing.assert_allclose(got.numpy(), np.linalg.solve(T, B.T).T, rtol=1e-10,
                               atol=1e-12)
    for i in range(3):
        assert torch.equal(t.solve(torch.from_numpy(B[i])), got[i])


def test_packed_solver_stores_in_the_solve_dtype_and_vmaps():
    args = _tv_system(300)
    t = PackedCyclicReductionSolver.from_tridiag(*args, dtype=torch.float32)
    assert all(v.dtype == torch.float32 for v in t.alphas + t.d_lv)
    b = torch.from_numpy(np.random.default_rng(0).standard_normal((4, 300))).float()
    assert torch.equal(torch.func.vmap(t.solve)(b), t.solve(b))
