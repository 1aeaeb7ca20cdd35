"""The whole engine tail in one pass (admm_tpu_torch/ops/kernels.py
``fused_zu_tail`` and ``fused_diff_tail``, the CPU side of K1b in
csrc/zu_tail.cu and of its difference-operator mode).

On the CPU both run ``_fused_zu_tail_torch``, which must equal the
engine's generic tail bit for bit (the LASSO's A = I, 1-D TV's A = D); the
kernel's own block split and summation order is emulated in NumPy and held
to the plain version's norms; the fused lasso and 1-D TV through the new
engine paths are held against admm_tpu's ``lasso(...,
use_fused_kernel=True)`` and ``totalvariation``; and TV's path is shown to
engage for plain 1-D TV alone.  The kernel itself runs only on a CUDA
device (tests/test_torch_gpu.py).
"""

import importlib
import math

import numpy as np
import pytest
import torch

from admm_tpu import ADMMConfig as JaxConfig
from admm_tpu import lasso as jax_lasso
from admm_tpu import totalvariation as jax_tv
from admm_tpu_torch import (ADMMConfig, Hooks, admm, fusedlasso, lasso, totalvariation,
                            totalvariation2d, tv_batch)
from admm_tpu_torch.models.lasso import _fused_zu, _prox_g, make_prox_ops
from admm_tpu_torch.ops import kernels
from admm_tpu_torch.ops.kernels import (
    ZU_THREADS, _fused_torch, fused_zu_tail, zu_blocks, zu_tail_plan)

engine_mod = importlib.import_module("admm_tpu_torch.engine")
tv_mod = importlib.import_module("admm_tpu_torch.models.totalvariation")

torch.set_num_threads(1)

DTYPES = [torch.float64, torch.float32]


def _instance(seed=2, rows=64, cols=128, density=0.6):
    # tests/test_lasso.py's generator (planted sparse signal + noise).
    rng = np.random.default_rng(seed)
    testx = rng.standard_normal(cols) * (rng.random(cols) < density)
    D = rng.standard_normal((rows, cols))
    D = D / np.sqrt(np.sum(D**2, axis=0, keepdims=True))
    s = D @ testx + np.sqrt(0.001) * rng.standard_normal(rows)
    return D, s, 0.1 * np.max(np.abs(D.T @ s))


def _same(a, b):
    """Equal values, NaN where the other has NaN (torch.equal is False on NaN)."""
    nan = torch.isnan(a)
    return torch.equal(nan, torch.isnan(b)) and torch.equal(a[~nan], b[~nan])


# ---- the plain tail against the engine's generic tail ------------------


def _solve(dtype, cfg_kw, tail, nan_after=None):
    """The fat static lasso through ``admm``: with ``tail`` the marked hook
    (the engine's fused_zu_tail path), else the same hook unmarked (the
    generic tail).  ``nan_after``: prox_f returns NaN from that call on."""
    D, s, lam = _instance()
    cfg = ADMMConfig(**cfg_kw)
    prox_f, _, obj, data = make_prox_ops(torch.from_numpy(D).to(dtype),
                                         torch.from_numpy(s).to(dtype), lam, cfg)
    calls = []

    def pf(x, z, u, rho, d):
        calls.append(1)
        x = prox_f(x, z, u, rho, d)
        return x * float("nan") if nan_after is not None and len(calls) > nan_after else x

    hook = _fused_zu if tail else (lambda x, u, rho, d: _fused_zu(x, u, rho, d))
    n = D.shape[1]
    return admm(pf, _prox_g, cfg, m=n, nA=n, nB=n, data=data, dtype=dtype,
                hooks=Hooks(obj=obj, fused_zu=hook), device="cpu")


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("cfg_kw,nan_after", [
    (dict(maxiters=47, domaxiters=True, unroll=1), None),
    (dict(maxiters=47, domaxiters=True, unroll=4), None),   # frozen at k = N
    (dict(maxiters=2000, unroll=5), None),                  # frozen once done
    (dict(maxiters=2000, unroll=3, nodualerror=True), None),
    (dict(maxiters=2000, unroll=4, objevals=True), None),
    (dict(maxiters=100, unroll=3), 5),                      # NaN under nanguard
    (dict(maxiters=10, unroll=4, nanguard=False), 5),       # NaN without it
])
def test_plain_tail_equals_engine_generic_tail(dtype, cfg_kw, nan_after):
    a = _solve(dtype, cfg_kw, tail=True, nan_after=nan_after)
    b = _solve(dtype, cfg_kw, tail=False, nan_after=nan_after)
    assert (a.steps, a.diverged) == (b.steps, b.diverged)
    for name in ("xopt", "zopt", "uopt"):
        assert _same(getattr(a, name), getattr(b, name))
    assert a.hist.keys() == b.hist.keys()
    for name in a.hist:
        # Whole (N,) buffers: NaN past the last step must match too.
        np.testing.assert_array_equal(a.hist[name].numpy(), b.hist[name].numpy())
    if nan_after is not None:
        assert a.diverged == cfg_kw.get("nanguard", True)
        assert a.steps == (nan_after + 1 if a.diverged else cfg_kw["maxiters"])


def _tv_signal(n, seed=7):
    rng = np.random.default_rng(seed)
    steps = np.repeat(rng.integers(1, 10, 8).astype(float), -(-n // 8))[:n]
    return steps + 0.5 * rng.standard_normal(n)


def _tv_solve(dtype, n, cfg_kw, tail, nan_after=None):
    """1-D TV through ``admm`` with TV's proxes: with ``tail`` the marked
    prox_g (the engine's fused_diff_tail path), else the same prox unmarked
    (the generic tail).  ``nan_after``: prox_f returns NaN from that call
    on.  Returns the result and the plain difference-operator tail's
    calls."""
    cfg = ADMMConfig(**cfg_kw)
    prox_f, prox_g, obj, data, D = tv_mod.make_prox_ops(
        torch.from_numpy(_tv_signal(n)).to(dtype), 1.0, cfg)
    assert prox_g is tv_mod._prox_g
    calls = []

    def pf(x, z, u, rho, d):
        calls.append(1)
        x = prox_f(x, z, u, rho, d)
        return x * float("nan") if nan_after is not None and len(calls) > nan_after else x

    pg = prox_g if tail else (lambda x, z, u, rho, d: prox_g(x, z, u, rho, d))
    tails = []
    plain = kernels._fused_zu_tail_torch

    def counted(*a, **kw):
        tails.append(kw["op"])
        return plain(*a, **kw)

    kernels._fused_zu_tail_torch = counted
    try:
        res = admm(pf, pg, cfg, A=D, B=-1.0, c=0.0, m=n, nA=n, nB=n, data=data, dtype=dtype,
                   hooks=Hooks(obj=obj), device="cpu")
    finally:
        kernels._fused_zu_tail_torch = plain
    return res, tails


_TV_CASES = [
    (257, dict(maxiters=13, domaxiters=True, unroll=1), None),
    (257, dict(maxiters=13, domaxiters=True, unroll=4), None),   # frozen at k = N
    (257, dict(maxiters=2000, unroll=5), None),                  # frozen once done
    (257, dict(maxiters=2000, unroll=3, nodualerror=True), None),
    (257, dict(maxiters=2000, unroll=4, objevals=True), None),
    (257, dict(maxiters=100, unroll=3), 5),                      # NaN under nanguard
    (257, dict(maxiters=10, unroll=4, nanguard=False), 5),       # NaN without it
    (1, dict(maxiters=2000, unroll=4), None),
    (2, dict(maxiters=2000, unroll=4), None),
    (3, dict(maxiters=2000, unroll=2), None),
    (65537, dict(maxiters=30, unroll=4), None),
]


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("n,cfg_kw,nan_after", _TV_CASES)
def test_diff_tail_equals_engine_generic_tail(dtype, n, cfg_kw, nan_after):
    a, tails = _tv_solve(dtype, n, cfg_kw, tail=True, nan_after=nan_after)
    b, none = _tv_solve(dtype, n, cfg_kw, tail=False, nan_after=nan_after)
    K = cfg_kw["unroll"]
    # Every sub-step, frozen ones too, went through the plain
    # difference-operator tail; the unmarked prox never did.
    assert len(tails) == (a.steps if K == 1 else -(-a.steps // K) * K) and none == []
    assert all(type(op).__name__ == "DiffOp" and op.n == n for op in tails)
    assert (a.steps, a.diverged) == (b.steps, b.diverged)
    for name in ("xopt", "zopt", "uopt"):
        assert _same(getattr(a, name), getattr(b, name))
    assert a.hist.keys() == b.hist.keys()
    for name in a.hist:
        np.testing.assert_array_equal(a.hist[name].numpy(), b.hist[name].numpy())
    if nan_after is not None:
        assert a.diverged == cfg_kw.get("nanguard", True)
        assert a.steps == (nan_after + 1 if a.diverged else cfg_kw["maxiters"])


def test_engine_leaves_the_callers_iterates_alone():
    D, s, lam = _instance()
    cfg = ADMMConfig(maxiters=20, domaxiters=True)
    prox_f, _, obj, data = make_prox_ops(torch.from_numpy(D), torch.from_numpy(s), lam, cfg)
    n = D.shape[1]
    x0, z0, u0 = (torch.full((n,), v, dtype=torch.float64) for v in (0.1, 0.2, 0.3))
    res = admm(prox_f, _prox_g, cfg, m=n, nA=n, nB=n, data=data, x0=x0, z0=z0, u0=u0,
               hooks=Hooks(fused_zu=_fused_zu), device="cpu")
    assert res.steps == 20
    for v, val in ((x0, 0.1), (z0, 0.2), (u0, 0.3)):
        assert torch.all(v == val)
    assert res.xopt.data_ptr() != x0.data_ptr()


# ---- one call of the plain tail: the freeze, the flags, the slot -------

N = 9


def _one_call(dtype, k=3, done=0, abstol=1e-4, nan=False, **flags):
    rng = np.random.default_rng(11)
    n = 40
    x_new, x, z, u = (torch.from_numpy(rng.standard_normal(n)).to(dtype) for _ in range(4))
    if nan:
        x_new[7] = float("nan")
    lam, rho = torch.tensor(0.3, dtype=dtype), torch.tensor(1.7, dtype=dtype)
    state = torch.tensor([k, done, 0])
    hist = torch.full((5, N + 1), float("nan"), dtype=dtype)
    before = [t.clone() for t in (x_new, x, z, u, state, hist)]
    kw = dict(perr_abs=math.sqrt(n) * abstol, derr_abs=math.sqrt(n) * abstol, reltol=1e-3,
              domaxiters=False, nodualerror=False, nanguard=True)
    kw.update(flags)
    fused_zu_tail(x_new, x, z, u, lam, rho, state, hist, **kw)
    return before, (x_new, x, z, u, state, hist), kw


def _expected(before, kw):
    """NumPy f64 of what the step computes from the inputs."""
    x_new, x, z, u = (t.double().numpy() for t in before[:4])
    t = 0.3 / 1.7
    zn, un = _fused_torch(torch.from_numpy(x_new), torch.from_numpy(u), t)
    zn, un = zn.numpy(), un.numpy()
    norms = [np.linalg.norm(x_new - zn), np.linalg.norm(1.7 * (zn - z)),
             kw["perr_abs"] + kw["reltol"] * max(np.linalg.norm(x_new), np.linalg.norm(zn)),
             kw["derr_abs"] + kw["reltol"] * np.linalg.norm(1.7 * un)]
    return zn, un, norms


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("case", ["step", "last", "done", "past_n", "stop", "domaxiters",
                                  "nodualerror", "nan_guarded", "nan_unguarded"])
def test_plain_tail_one_step(dtype, case):
    args = {
        "step": dict(), "last": dict(k=N - 1), "done": dict(done=1), "past_n": dict(k=N),
        "stop": dict(abstol=1e3), "domaxiters": dict(abstol=1e3, domaxiters=True),
        "nodualerror": dict(abstol=1e3, nodualerror=True), "nan_guarded": dict(nan=True),
        "nan_unguarded": dict(nan=True, nanguard=False),
    }[case]
    before, after, kw = _one_call(dtype, **args)
    x_new, x, z, u, state, hist = after
    k0 = int(before[4][0])
    frozen = case in ("done", "past_n")
    slot = N if frozen else k0
    # Only column `slot` of rows 0-3 is written; row 4 (objvals) is the engine's.
    untouched = torch.ones_like(hist, dtype=torch.bool)
    untouched[:4, slot] = False
    assert torch.equal(torch.isnan(hist[untouched]), torch.isnan(before[5][untouched]))
    assert _same(x_new, before[0])
    if frozen:
        for got, old in zip((x, z, u, state), before[1:5]):
            assert _same(got, old)
    else:
        zn, un = _fused_torch(before[0], before[3], torch.tensor(0.3, dtype=dtype)
                              / torch.tensor(1.7, dtype=dtype))
        for got, ref in ((x, before[0]), (z, zn), (u, un)):
            assert _same(got, ref)
        stop = case in ("stop", "nodualerror")
        diverged = case == "nan_guarded"
        assert state.tolist() == [k0 + 1, int(stop or diverged), int(diverged)]
    col = hist[:4, slot].double().numpy()
    if case.startswith("nan"):
        assert np.isnan(col[0])
        return
    _, _, ref = _expected(before, kw)
    if kw["nodualerror"]:
        assert np.isnan(col[1]) and np.isnan(col[3])
        col, ref = col[[0, 2]], np.asarray(ref)[[0, 2]]
    rtol = 1e-12 if dtype == torch.float64 else 1e-5
    np.testing.assert_allclose(col, ref, rtol=rtol)


def test_fused_zu_tail_checks_its_operands():
    _, (x_new, x, z, u, state, hist), kw = _one_call(torch.float64)
    lam, rho = torch.tensor(0.3, dtype=torch.float64), torch.tensor(1.7, dtype=torch.float64)
    for key in ("domaxiters", "nodualerror", "nanguard"):
        kw.pop(key)
    with pytest.raises(ValueError, match="one shape"):
        fused_zu_tail(x_new, x[:5], z, u, lam, rho, state, hist, **kw)
    with pytest.raises(ValueError, match="int64 state"):
        fused_zu_tail(x_new, x, z, u, lam, rho, state.double(), hist, **kw)
    with pytest.raises(ValueError, match="rows >= 4"):
        fused_zu_tail(x_new, x, z, u, lam, rho, state, hist[:3], **kw)
    meta = torch.zeros(40, dtype=torch.float64, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        fused_zu_tail(meta, meta, meta, meta, lam.to("meta"), rho.to("meta"),
                      state.to("meta"), hist.to("meta"), **kw)


# ---- the kernel's summation order, emulated -----------------------------


def _tree(v):
    """csrc/zu_tail.cu block_sum over the last axis of 256 threads: shuffle
    down within each warp of 32 (lane 0's chain), then the 8 warp sums in
    order from zero."""
    v = v.reshape(v.shape[:-1] + (ZU_THREADS // 32, 32)).copy()
    for off in (16, 8, 4, 2, 1):
        v[..., :off] = v[..., :off] + v[..., off:2 * off]
    s = np.zeros(v.shape[:-2], v.dtype)
    for w in range(v.shape[-2]):
        s = s + v[..., w, 0]
    return s


def _kernel_norms(x_new, z, u, t, rho, vec):
    """NumPy emulation of the tail mode's sums and norms, in the working
    dtype, in the kernel's order: per thread its 16-byte chunks (vec) and
    then its scalar elements of the grid-stride loop, per block the tree,
    then across blocks the cluster's block order or the ticket's last
    block (a strided share of the partials per thread, and the tree)."""
    dt = x_new.dtype
    n = x_new.size
    W = 16 // dt.itemsize
    blocks = zu_blocks(n, dt.itemsize)
    stride = blocks * ZU_THREADS
    v = x_new + u
    zn = np.where(v > t, v - t, np.where(v < -t, v + t, v * dt.type(0)))
    un = (u + x_new) - zn
    p, d, w = x_new - zn, rho * (zn - z), rho * un
    terms = np.stack([p * p, d * d, x_new * x_new, zn * zn, w * w])
    acc = np.zeros((5, stride), dt)
    g = np.arange(stride)
    nv = n // W if vec else 0
    c = g.copy()
    while (live := c < nv).any():
        for lane in range(W):
            acc[:, live] += terms[:, c[live] * W + lane]
        c += stride
    i = nv * W + g
    while (live := i < n).any():
        acc[:, live] += terms[:, i[live]]
        i += stride
    partial = _tree(acc.reshape(5, blocks, ZU_THREADS))          # (5, blocks)
    if zu_tail_plan(n, dt.itemsize)[1]:
        # One cluster: block 0 adds the blocks' sums in block order.
        tot = np.zeros(5, dt)
        for b in range(blocks):
            tot = tot + partial[:, b]
        return np.sqrt(tot)
    # The ticket: the last block's threads take strided shares, then the tree.
    tot = np.zeros((5, ZU_THREADS), dt)
    for b0 in range(0, blocks, ZU_THREADS):
        share = partial[:, b0:b0 + ZU_THREADS]
        tot[:, :share.shape[1]] += share
    return np.sqrt(_tree(tot))


@pytest.mark.parametrize("vec", [True, False])
@pytest.mark.parametrize("dtype", [np.float64, np.float32])
@pytest.mark.parametrize("n", [1, 7, 1000, 5000, 70000, 300001])
def test_kernel_summation_order_within_tolerance_of_plain(n, dtype, vec):
    rng = np.random.default_rng(n)
    x_new, z, u = (rng.standard_normal(n).astype(dtype) for _ in range(3))
    t, rho = dtype(0.37), dtype(1.3)
    emu = _kernel_norms(x_new, z, u, t, rho, vec)
    X, Z, U = (torch.from_numpy(a) for a in (x_new, z, u))
    zn, un = _fused_torch(X, U, torch.tensor(t))
    R = torch.tensor(rho)
    plain = [torch.sqrt(torch.sum(v * v)).item()
             for v in (X - zn, R * (zn - Z), X, zn, R * un)]
    # Sums of positive squares in another order: relative error about
    # log2(n) eps, far under these bars.
    rtol = 1e-12 if dtype == np.float64 else 1e-5
    np.testing.assert_allclose(emu, plain, rtol=rtol)


# ---- the slice: the fused lasso against admm_tpu -------------------------


@pytest.mark.parametrize("seed,unroll", [(2, 1), (3, 4), (4, 16)])
def test_fused_lasso_matches_jax_f64(seed, unroll, monkeypatch):
    calls = []
    plain = kernels._fused_zu_tail_torch
    monkeypatch.setattr(kernels, "_fused_zu_tail_torch",
                        lambda *a, **kw: (calls.append(1), plain(*a, **kw)))
    D, s, lam = _instance(seed)
    cfg = dict(maxiters=5000, objevals=True, unroll=unroll)
    jres = jax_lasso(D, s, lam, JaxConfig(**cfg), use_fused_kernel=True)
    res = lasso(D, s, lam, ADMMConfig(**cfg), use_fused_kernel=True, device="cpu")
    assert res.steps == jres.steps < 5000
    assert len(calls) == -(-res.steps // unroll) * unroll  # every step, frozen ones too
    for name in ("xopt", "zopt", "uopt"):
        np.testing.assert_allclose(getattr(res, name).numpy(),
                                   np.asarray(getattr(jres, name)), rtol=1e-9, atol=1e-10)
    for name in ("pnorm", "dnorm", "perr", "derr", "objvals"):
        ref = jres.trace(name)
        np.testing.assert_allclose(res.trace(name), ref, rtol=0, atol=1e-8 * abs(ref[0]))
    np.testing.assert_allclose(res.objopt, jres.objopt, rtol=1e-10)


@pytest.mark.parametrize("unroll", [1, 4, 16])
def test_tv_diff_tail_matches_jax_f64(unroll, monkeypatch):
    calls = []
    plain = kernels._fused_zu_tail_torch
    monkeypatch.setattr(kernels, "_fused_zu_tail_torch",
                        lambda *a, **kw: (calls.append(kw["op"]), plain(*a, **kw))[1])
    sig = _tv_signal(3000, seed=unroll)
    cfg = dict(maxiters=5000, objevals=True, unroll=unroll)
    jres = jax_tv(sig, 1.0, JaxConfig(**cfg), solver="cr")
    res = totalvariation(sig, 1.0, ADMMConfig(**cfg), solver="cr", device="cpu")
    assert res.steps == jres.steps < 5000
    assert len(calls) == -(-res.steps // unroll) * unroll and calls[0] is not None
    for name in ("xopt", "zopt", "uopt"):
        ref = np.asarray(getattr(jres, name))
        np.testing.assert_allclose(getattr(res, name).numpy(), ref, rtol=1e-9,
                                   atol=1e-10 * np.max(np.abs(ref)))
    for name in ("pnorm", "dnorm", "perr", "derr", "objvals"):
        ref = jres.trace(name)
        np.testing.assert_allclose(res.trace(name), ref, rtol=0, atol=1e-8 * abs(ref[0]))
    np.testing.assert_allclose(res.objopt, jres.objopt, rtol=1e-10)


def _tv_case(name):
    sig = _tv_signal(600)
    cfg = dict(maxiters=60, unroll=4)
    if name == "tv_batch":
        return lambda: tv_batch(np.stack([sig, -sig]), 1.0, ADMMConfig(**cfg), solver="cr",
                                device="cpu")
    if name == "fusedlasso":
        return lambda: fusedlasso(sig, 0.1, 1.0, ADMMConfig(**cfg), device="cpu")
    if name == "tv2d":
        return lambda: totalvariation2d(sig[:576].reshape(24, 24), 1.0, ADMMConfig(**cfg),
                                        device="cpu")
    if name == "requires_grad":
        s = torch.from_numpy(sig).requires_grad_()
        return lambda: totalvariation(s, 1.0, ADMMConfig(**cfg), solver="cr", device="cpu")
    opts = {"plain": {}, "plain_dense": {}, "relax": dict(relax=1.6),
            "adaptive": dict(adaptive=True, convtest=True), "rbadaptive": dict(rbadaptive=True),
            "stallwindow": dict(stallwindow=10), "anderson": dict(anderson=3),
            "record_iterates": dict(record_iterates=True), "hnorm": dict(stopcond="both")}[name]
    solver = "dense" if name == "plain_dense" or "adaptive" in name else "cr"
    return lambda: totalvariation(sig, 1.0, ADMMConfig(**cfg, **opts), solver=solver,
                                  device="cpu")


@pytest.mark.parametrize("name", ["plain", "plain_dense", "tv_batch", "relax", "adaptive",
                                  "rbadaptive", "stallwindow", "anderson", "record_iterates",
                                  "hnorm", "fusedlasso", "tv2d", "requires_grad"])
def test_diff_tail_engages_for_plain_1d_tv_alone(name, monkeypatch):
    """TV's marked z-prox takes fused_diff_tail for one 1-D signal under
    the standard stop, whatever its x-update; every option or family the
    tail does not compute keeps the generic tail."""
    calls = []
    real = engine_mod.fused_diff_tail
    monkeypatch.setattr(engine_mod, "fused_diff_tail",
                        lambda *a, **k: (calls.append(1), real(*a, **k))[1])
    res = _tv_case(name)()
    assert res is not None
    assert (len(calls) > 0) == name.startswith("plain")
