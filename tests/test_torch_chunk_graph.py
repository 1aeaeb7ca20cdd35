"""The engine's captured chunks (``admm_tpu_torch/graphs.py``).

On the CPU: which solves the engine would capture.  With the device check
made to pass and ``graphs.ChunkGraph`` replaced by a recorder that runs
each sub-step, commit and flags eagerly (as each replay of the captured
sub-step would), a solve that captures records one graph and
gives the eager solve's steps, histories and iterates bit for bit; a CPU
solve, a user's prox, the quiet=False table, Anderson's window, a solve
that autograd or a ``torch.func`` transform follows, the sharded loop
(``parallel/_loop``) and an eigh-prox family record none.

On a CUDA device (``gpu``, skipped without one): the captured chunk
against the eager one on the benchmark's solves (the fused LASSO at
1500 x 5000, TV at n = 65536, a 100-lambda LASSO path, a solve that stops
inside its first chunk, and the bf16-stream LASSO), the device memory over
50 solves, and two device syncs a solve under ``torch.profiler``.

    python -m pytest tests/test_torch_chunk_graph.py -m gpu --noconftest -p no:cacheprovider
"""

import importlib

import numpy as np
import pytest
import torch

from admm_tpu_torch import (ADMMConfig, admm, covarianceselection, engine, graphs, lasso,
                            lasso_path, make_admm_runner, totalvariation, tv_batch)
from admm_tpu_torch.linop import DenseOp, DiffOp, FnOp, ScaledIdentityOp, StackIDiffOp
from admm_tpu_torch.ops import kernels, tridiag
from admm_tpu_torch.parallel import consensus_lasso

torch.set_num_threads(1)
lasso_mod = importlib.import_module("admm_tpu_torch.models.lasso")
tv_mod = importlib.import_module("admm_tpu_torch.models.totalvariation")


def _fat_lasso(m=30, n=80, seed=3):
    rng = np.random.default_rng(seed)
    D = rng.standard_normal((m, n))
    D /= np.linalg.norm(D, axis=0)
    s = D @ (rng.standard_normal(n) * (rng.random(n) < 0.1)) + 0.03 * rng.standard_normal(m)
    return D, s, 0.1 * float(np.max(np.abs(D.T @ s)))


def _signal(n=4096, seed=4):
    rng = np.random.default_rng(seed)
    return np.repeat(rng.integers(1, 10, 8).astype(float), n // 8) + rng.standard_normal(n)


class _Recorder(graphs.ChunkGraph):
    """A ``ChunkGraph`` that runs the chunk eagerly at every call, as each
    replay of the capture would, and records that it was made."""

    made = []

    def __init__(self, device, kind, commit=None):
        _Recorder.made.append(kind)
        super().__init__(device, kind, commit)

    def __call__(self, step, flags, K):
        if K == 1:
            self.flags = torch.empty(2, dtype=torch.int64, device=self.device)
        for _ in range(K):
            self._body(step, flags if K == 1 else None)
        return self.flags if K == 1 else flags()


class _Refuse(graphs.ChunkGraph):
    def __init__(self, *args, **kwargs):
        raise AssertionError("a capture was attempted")


@pytest.fixture
def recorded(monkeypatch):
    """Solves as if on a device that captures; yields the kinds recorded."""
    monkeypatch.setattr(graphs, "available", lambda device: True)
    monkeypatch.setattr(graphs, "ChunkGraph", _Recorder)
    _Recorder.made = []
    yield _Recorder.made


def _solve(case):
    D, s, lam = _fat_lasso()
    if case == "lasso_fused":
        return lasso(D, s, lam, ADMMConfig(maxiters=300, unroll=8), use_fused_kernel=True,
                     device="cpu")
    if case == "lasso_fused_objevals":
        return lasso(D, s, lam, ADMMConfig(maxiters=300, unroll=8, objevals=True),
                     use_fused_kernel=True, device="cpu")
    if case == "lasso_k1":  # the K1 hook under an option K1b does not compute
        return lasso(D, s, lam, ADMMConfig(maxiters=300, unroll=4, stallwindow=7),
                     use_fused_kernel=True, device="cpu")
    if case == "lasso_k1_unrolled_once":
        return lasso(D, s, lam, ADMMConfig(maxiters=300, unroll=1, stopcond="hnorm"),
                     use_fused_kernel=True, device="cpu")
    if case == "lasso_fast":
        return lasso(D, s, lam, ADMMConfig(maxiters=300, unroll=3, fast=True), device="cpu")
    if case == "lasso_accelerated":
        return lasso(D, s, lam, ADMMConfig(maxiters=300, unroll=3, fast=True,
                                           fasttype="strong"), device="cpu")
    if case == "lasso_hnorm_records":
        return lasso(D, s, lam, ADMMConfig(maxiters=200, unroll=5, stopcond="both",
                                           convtest=True, record_iterates=True), device="cpu")
    if case == "tv":
        return totalvariation(_signal(), 5.0, ADMMConfig(maxiters=60, unroll=4), solver="cr",
                              device="cpu")
    if case == "tv_relaxed":
        return totalvariation(_signal(), 5.0, ADMMConfig(maxiters=60, unroll=4, relax=1.6),
                              solver="cr_packed", device="cpu")
    if case == "path":
        return lasso_path(D, s, lam * np.array([4.0, 1.0, 0.25]),
                          ADMMConfig(maxiters=300, unroll=2), device="cpu")
    if case == "path_once":
        return lasso_path(D, s, lam * np.array([4.0, 1.0, 0.25]),
                          ADMMConfig(maxiters=300, unroll=1), device="cpu")
    assert case == "tv_batch"
    S = np.stack([_signal(3000, seed) for seed in (5, 6)])
    return tv_batch(S, 2.0, ADMMConfig(maxiters=50), solver="cr", device="cpu")


def _same(a, b):
    torch.testing.assert_close(torch.as_tensor(a.steps), torch.as_tensor(b.steps), rtol=0, atol=0)
    for name in ("xopt", "zopt", "uopt"):
        torch.testing.assert_close(getattr(a, name), getattr(b, name), rtol=0, atol=0)
    assert set(a.hist) == set(b.hist)
    for name in a.hist:
        torch.testing.assert_close(a.hist[name], b.hist[name], rtol=0, atol=0, equal_nan=True)


CAPTURED = ["lasso_fused", "lasso_fused_objevals", "lasso_k1", "lasso_k1_unrolled_once",
            "lasso_fast", "lasso_accelerated", "lasso_hnorm_records", "tv", "tv_relaxed", "path",
            "path_once", "tv_batch"]


@pytest.mark.parametrize("case", CAPTURED)
def test_replayed_chunks_give_the_eager_solve(recorded, monkeypatch, case):
    # The chunk on the solve's own buffers, committed and re-read at every
    # replay, against the unchanged eager loop.
    replayed = _solve(case)
    assert len(recorded) == 1
    monkeypatch.setattr(graphs, "available", lambda device: False)
    _same(replayed, _solve(case))
    assert len(recorded) == 1


def test_replayed_chunks_leave_the_callers_iterates(recorded):
    D, s, lam = _fat_lasso()
    x0, z0, u0 = (torch.full((80,), v, dtype=torch.float64) for v in (0.1, 0.2, 0.3))
    kept = [t.clone() for t in (x0, z0, u0)]
    for fused in (False, True):
        res = lasso(D, s, lam, ADMMConfig(maxiters=40, unroll=4), use_fused_kernel=fused,
                    x0=x0, z0=z0, u0=u0, device="cpu")
        assert res.steps > 4
    assert len(recorded) == 2
    for t, k in zip((x0, z0, u0), kept):
        assert torch.equal(t, k)


def test_no_capture_on_the_cpu(monkeypatch):
    monkeypatch.setattr(graphs, "ChunkGraph", _Refuse)
    for case in ("lasso_fused", "tv", "path"):
        _solve(case)
    assert not graphs.available(torch.device("cpu"))


def _user_prox():
    D, s, lam = _fat_lasso()
    D, s = torch.as_tensor(D), torch.as_tensor(s)
    M = torch.linalg.inv(D.T @ D + torch.eye(80, dtype=D.dtype))
    return admm(lambda x, z, u, rho: M @ (D.T @ s + rho * (z - u)),
                lambda x, z, u, rho: torch.sign(x + u) * torch.clamp_min((x + u).abs() - lam, 0),
                ADMMConfig(maxiters=100, unroll=4), m=80, dtype=D.dtype, device="cpu")


def _unmarked_operator():
    # The LASSO's marked proxes with A given as callables: an FnOp.
    D, s, lam = _fat_lasso()
    prox_f, prox_g, obj, data = lasso_mod.make_prox_ops(torch.as_tensor(D), torch.as_tensor(s),
                                                        lam)
    return admm(prox_f, prox_g, ADMMConfig(maxiters=50, unroll=4),
                A=FnOp(lambda v: v, lambda v: v), m=80, nA=80, nB=80, data=data,
                dtype=torch.float64, device="cpu")


def _requires_grad():
    D, s, lam = _fat_lasso()
    D = torch.as_tensor(D).requires_grad_()
    return lasso(D, torch.as_tensor(s), lam, ADMMConfig(maxiters=50, unroll=4), device="cpu")


def _runner_followed_by_grad():
    D, s, lam = _fat_lasso()
    prox_f, prox_g, obj, data = lasso_mod.make_prox_ops(torch.as_tensor(D), torch.as_tensor(s),
                                                        lam)
    run = make_admm_runner(prox_f, prox_g, ADMMConfig(maxiters=50, unroll=4), 1.0, -1.0,
                           has_data=True)
    x0 = torch.zeros(80, dtype=torch.float64, requires_grad=True)
    return run(x0, torch.zeros(80, dtype=torch.float64), torch.zeros(80, dtype=torch.float64),
               0.0, data)


NOT_CAPTURED = {
    "user_prox": _user_prox,
    "unmarked_operator": _unmarked_operator,
    "requires_grad_data": _requires_grad,
    "requires_grad_iterate": _runner_followed_by_grad,
    "table": lambda: lasso(*_fat_lasso(), ADMMConfig(maxiters=20, unroll=4, quiet=False),
                           use_fused_kernel=True, device="cpu"),
    "anderson": lambda: lasso(*_fat_lasso(), ADMMConfig(maxiters=40, unroll=4, anderson=3),
                              device="cpu"),
    "parallel_loop": lambda: consensus_lasso(*_fat_lasso(m=64), ADMMConfig(maxiters=60),
                                             nshards=4, device="cpu"),
    "eigh_prox": lambda: covarianceselection(
        np.random.default_rng(8).standard_normal((40, 6)), 0.1,
        ADMMConfig(maxiters=30, unroll=4), prox_method="eigh", device="cpu"),
    "tv_dense_prox": lambda: totalvariation(_signal(512), 5.0, ADMMConfig(maxiters=30),
                                            solver="dense", device="cpu"),
}


@pytest.mark.parametrize("case", sorted(NOT_CAPTURED))
def test_solves_that_are_not_captured(monkeypatch, case):
    monkeypatch.setattr(graphs, "available", lambda device: True)
    monkeypatch.setattr(graphs, "ChunkGraph", _Refuse)
    res = NOT_CAPTURED[case]()
    assert res is not None


def test_a_transform_follows_the_solve():
    plain = torch.ones(3)
    assert not engine._followed(None, plain)
    assert engine._followed({"lam": plain.clone().requires_grad_()}, plain)
    with torch.no_grad():
        assert not engine._followed({"lam": plain.clone().requires_grad_()}, plain)
    seen = []

    def under_vmap(v):
        seen.append((engine._followed(None, v), engine._followed(None, plain)))
        return v

    torch.func.vmap(under_vmap)(torch.ones(2, 3))
    torch.func.grad(lambda v: under_vmap(v).sum())(torch.ones(3))
    assert seen == [(True, True), (True, True)]


@pytest.mark.parametrize("fn", [lasso_mod._prox_f_fat_static, lasso_mod._prox_g, lasso_mod._obj,
                                lasso_mod._fused_zu, tv_mod._prox_f_cr, tv_mod._prox_g,
                                tv_mod._prox_g_relaxed, tv_mod._obj, ScaledIdentityOp, DenseOp,
                                DiffOp, StackIDiffOp])
def test_the_lasso_and_tv_prox_ops_are_marked(fn):
    assert graphs.is_capture_safe(fn)


@pytest.mark.parametrize("fn", [lasso_mod._prox_f_static, lasso_mod._prox_f_fat,
                                tv_mod._prox_f_static, tv_mod._prox_f_cr_plain, FnOp,
                                lambda x, z, u, rho: x])
def test_other_callables_are_not_marked(fn):
    assert not graphs.is_capture_safe(fn)


# ---------------------------------------------------------------------------
# On a CUDA device.


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _eager(monkeypatch, solve):
    monkeypatch.setattr(graphs, "available", lambda device: False)
    try:
        return solve()
    finally:
        monkeypatch.undo()


def _replays(solve):
    """``solve()`` with its replays counted: (result, replays)."""
    made, call = [], graphs.ChunkGraph.__call__

    def counted(self, step, flags, K):
        made.append(self)
        return call(self, step, flags, K)

    graphs.ChunkGraph.__call__ = counted
    try:
        res = solve()
    finally:
        graphs.ChunkGraph.__call__ = call
    return res, sum(g.graph is not None for g in made)


def _headline(cuda):
    from admm_tpu_torch.benchmarks.headline import make_problem

    D, s, lam = make_problem()
    return torch.as_tensor(D, device=cuda), torch.as_tensor(s, device=cuda), lam


def _card_solves(cuda):
    D, s, lam = _headline(cuda)
    sig = torch.as_tensor(_signal(65536, 9), dtype=torch.float32, device=cuda)
    lmax = float((D.T @ s).abs().max())
    lams = lmax * 0.01 ** (torch.arange(100, device=cuda, dtype=torch.float32) / 99)
    cfg = ADMMConfig(abstol=1e-5, reltol=1e-3, unroll="auto", matmul_precision="highest")
    return {
        "lasso_fused": lambda: lasso(D, s, lam, cfg, use_fused_kernel=True),
        "tv": lambda: totalvariation(sig, 5.0, cfg),
        "path": lambda: lasso_path(D, s, lams, cfg),
        "first_chunk_stop": lambda: lasso(D, s, lam, ADMMConfig(unroll=64),
                                          use_fused_kernel=True),
        "lasso_bf16": lambda: lasso(D, s, lam, ADMMConfig(maxiters=200, unroll=8),
                                    stream_dtype=torch.bfloat16),
    }


@pytest.mark.gpu
@pytest.mark.parametrize("case", ["lasso_fused", "tv", "path", "first_chunk_stop", "lasso_bf16"])
def test_captured_chunk_on_the_card_equals_the_eager_one(cuda, monkeypatch, case):
    solve = _card_solves(cuda)[case]
    solve()  # the process's first solve of its kind: its first chunk runs eagerly
    tail, k4 = kernels.fused_zu_tail.launches, tridiag.cr_solve.launches
    captured, replays = _replays(solve)
    eager = _eager(monkeypatch, solve)
    steps = int(torch.as_tensor(captured.steps).max())
    K = {"lasso_fused": 16, "tv": 4, "path": 1, "first_chunk_stop": 64, "lasso_bf16": 8}[case]
    assert replays == -(-steps // K) >= 1
    if case == "first_chunk_stop":
        assert replays == 1 and steps < K
    _same(captured, eager)
    # The launch counters count the kernels each replay ran.
    assert kernels.fused_zu_tail.launches - tail == (
        2 * K * replays if case in ("lasso_fused", "first_chunk_stop") else 0)
    assert tridiag.cr_solve.launches - k4 == (2 * K * replays if case == "tv" else 0)


@pytest.mark.gpu
def test_device_memory_holds_over_fifty_solves(cuda):
    D, s, lam = _headline(cuda)
    sig = torch.as_tensor(_signal(65536, 9), dtype=torch.float32, device=cuda)

    def solves():
        lasso(D, s, lam, ADMMConfig(), use_fused_kernel=True)
        totalvariation(sig, 5.0, ADMMConfig(maxiters=40))
        torch.cuda.synchronize()

    solves()
    first = torch.cuda.memory_reserved(), torch.cuda.memory_allocated()
    for _ in range(49):
        solves()
    last = torch.cuda.memory_reserved(), torch.cuda.memory_allocated()
    assert last[0] <= 1.05 * first[0] and last[1] <= 1.05 * first[1], (first, last)


@pytest.mark.gpu
def test_two_device_syncs_a_solve_under_the_profiler(cuda):
    # The benchmark finds a request's loop between the request's first two
    # cudaDeviceSynchronize calls: a captured solve makes exactly two, one
    # before its loop span and one after it.
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function

    solves = _card_solves(cuda)
    for case in ("lasso_fused", "tv", "path", "first_chunk_stop"):
        solves[case]()  # warm
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            with record_function("request"):
                solves[case]()
        events = sorted((e for e in prof.events() if e.device_type == DeviceType.CPU),
                        key=lambda e: e.time_range.start)
        (req,) = [e for e in events if e.name == "request"]
        inside = [e for e in events if req.time_range.start <= e.time_range.start
                  and e.time_range.end <= req.time_range.end]
        syncs = [e for e in inside if e.name == "cudaDeviceSynchronize"]
        (loop,) = [e for e in inside if e.name == "admm_tpu_torch.loop"]
        names = [e.name for e in inside]
        assert len(syncs) == 2, (case, len(syncs))
        assert syncs[0].time_range.end <= loop.time_range.start
        assert loop.time_range.end <= syncs[1].time_range.start
        assert names.count("admm_tpu_torch.capture") == 1
        assert names.count("admm_tpu_torch.replay") == names.count("admm_tpu_torch.chunk") >= 1
