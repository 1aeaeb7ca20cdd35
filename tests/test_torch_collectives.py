"""The collectives of the port's sharded runners (admm_tpu_torch.parallel):
the count and payload of every reduction over the shard axis, per
sub-step, against the payloads admm_tpu's docstrings state (consensus:
2n floats plus its scalars, parallel/consensus.py:83-85; exchange: n
floats, exchange.py:61; the sharded SDP: m + n^2 floats, sdp.py:20;
transpose reduction: the n-float psi-sum), counted by ``Mesh.stats`` on
a stacked mesh of 8 shards; and a process group of one rank (gloo, in
this process) computing what the stacked mesh computes, bit for bit,
with the same counts.  Each run takes ``domaxiters`` so that every solve
runs its N sub-steps."""

import numpy as np
import pytest
import torch

import admm_tpu_torch as T
import admm_tpu_torch.parallel as TP
from admm_tpu_torch.models.sdp import random_sdp_instance
from admm_tpu_torch.parallel import multihost
from admm_tpu_torch.utils.validate import slicemaker

torch.set_num_threads(1)

F64 = 8  # bytes of a float64 payload element
N = 6    # sub-steps of every counted solve


def _stacked(n=8):
    return TP.make_mesh(n, device="cpu")


def _lasso(seed=0, m=203, n=12):
    rng = np.random.default_rng(seed)
    return rng.standard_normal((m, n)), rng.standard_normal(m)


def _counts(mesh):
    st = mesh.reset_stats()
    return st["calls"], st["bytes"]


def _cfg(**kw):
    return T.ADMMConfig(maxiters=N, domaxiters=True, **kw)


@pytest.mark.parametrize("kw,per_call,per_bytes", [
    # plain: (xbar, ubar) 2n floats, then pnorm's scalar.
    ({}, 2, lambda n: 2 * n + 1),
    # relaxation and residual balancing add nothing.
    (dict(relax=1.5), 2, lambda n: 2 * n + 1),
    (dict(rbadaptive=True), 2, lambda n: 2 * n + 1),
    # fast (alg 1): momentum is elementwise; nothing added.
    (dict(fast=True, fasttype="strong"), 2, lambda n: 2 * n + 1),
    # accelerated (alg 2): the d-value's dual part rides with pnorm.
    (dict(fast=True), 2, lambda n: 2 * n + 2),
    # Anderson (window 3): the residual norm, then the 3x3 Gram and its
    # right-hand side, each a collective of the sharded leaf's part.
    (dict(anderson=3), 4, lambda n: 2 * n + 1 + 1 + 9 + 3),
])
def test_consensus_collectives_per_step(kw, per_call, per_bytes):
    D, s = _lasso()
    n, W = D.shape[1], 8
    mesh = _stacked(W)
    TP.consensus_lasso(D, s, 0.3, _cfg(**kw), mesh=mesh, nshards=W)
    calls, nbytes = _counts(mesh)
    assert calls == {"all_reduce": per_call * N, "all_gather": 1}
    assert nbytes["all_reduce"] == per_bytes(n) * N * F64
    assert nbytes["all_gather"] == 2 * W * n * F64   # xi and ui, once at the end


@pytest.mark.parametrize("kw,extra_floats", [
    # linearsvm_sharded: stopcond 'both' (the H-norm's two parts), no dual test.
    ({}, 2),
    (dict(relax=1.5), 2),
    (dict(fast=True), 4),                    # and the d-value's two parts
])
def test_transpose_reduction_collectives_per_step(kw, extra_floats):
    D, s = _lasso()
    ell = np.sign(s)
    n, W = D.shape[1], 8
    mesh = _stacked(W)
    TP.linearsvm_sharded(D, ell, 1.0, _cfg(**kw), mesh=mesh, nshards=W)
    calls, nbytes = _counts(mesh)
    # Setup: the Gram's shard sum (n^2); a step: the n-float psi-sum, then
    # the norms' three scalars (and the extras); the end: the
    # objective's shard sum and the row-space z/u gathered.
    assert calls == {"all_reduce": 1 + 2 * N + 1, "all_gather": 1}
    assert nbytes["all_reduce"] == (n * n + N * (n + 3 + extra_floats) + 1) * F64
    mp = -(-D.shape[0] // W) * W
    assert nbytes["all_gather"] == 2 * mp * F64


def test_transpose_reduction_dual_test_sends_two_n_float_sums():
    D, s = _lasso()
    n, W = D.shape[1], 8
    mesh = _stacked(W)
    TP.unwrapped_admm_sharded(TP.transpose_reduction._svm_prox_hinge, D, _cfg(),
                              aux=(np.sign(s), np.ones_like(s), np.ones_like(s)), mesh=mesh,
                              nshards=W)
    calls, nbytes = _counts(mesh)
    assert calls["all_reduce"] == 1 + 2 * N
    assert nbytes["all_reduce"] == (n * n + N * (n + 3 + 2 * n)) * F64


@pytest.mark.parametrize("kw,scalars,means", [
    ({}, 3, 1),                                       # the mean over agents: n floats
    (dict(relax=1.5), 4, 2),                          # the relaxed mean rides along
    (dict(fast=True), 4, 1),                          # the d-value's agent part
    (dict(fast=True, fasttype="strong"), 3, 1),
])
def test_exchange_collectives_per_step(kw, scalars, means):
    rng = np.random.default_rng(3)
    W, n = 8, 6
    As, bs = rng.standard_normal((W, 12, n)), rng.standard_normal((W, 12))
    mesh = _stacked(W)
    TP.exchange_quadratic(As, bs, _cfg(**kw), mesh=mesh)
    calls, nbytes = _counts(mesh)
    assert calls == {"all_reduce": 2 * N, "all_gather": 1}
    assert nbytes["all_reduce"] == N * (means * n + scalars) * F64


def test_sdp_collectives_per_step():
    rng = np.random.default_rng(4)
    n, m, W = 6, 10, 4
    C, A, b, *_ = random_sdp_instance(n, m, 2, rng)
    mesh = _stacked(W)
    TP.sdp_sharded(C, A, b, _cfg(), mesh=mesh)
    calls, nbytes = _counts(mesh)
    m_pad = -(-m // W) * W
    # One x-prox a step: the m residuals gathered, the n^2 correction summed.
    assert calls == {"all_gather": N, "all_reduce": N}
    assert nbytes["all_gather"] == N * m_pad * F64
    assert nbytes["all_reduce"] == N * n * n * F64


def test_sliced_prox_on_a_stacked_mesh_counts_nothing():
    W, n = 4, 19
    mesh = _stacked(W)
    lengths = slicemaker(0, n, W)
    prox = TP.make_sliced_prox(lambda x, z, u, rho, k: torch.zeros(max(lengths),
                                                                   dtype=torch.float64),
                               lengths, mesh)
    z = torch.zeros(n, dtype=torch.float64)
    prox(z, z, z, 1.0)
    calls, nbytes = _counts(mesh)
    # On a stacked mesh the slices are stacked in place: nothing counted;
    # over a group one gather of the (W, L) blocks (test below).
    assert calls == {}


def test_lanes_over_a_mesh_issue_no_collective_per_step():
    D, s = _lasso()
    S = np.stack([s, -s, 0.5 * s, 2 * s])
    mesh = TP.make_mesh2d(2, 2, device="cpu")
    TP.consensus_lasso_batch(D, S, 0.3, _cfg(), mesh=mesh, nshards=4)
    calls, _ = _counts(mesh)
    # The lanes' local mesh counts its stacked reductions in its own
    # stats; the 2-D mesh itself sees only the gather (none when stacked).
    assert calls == {}


# ---- a process group of one rank: the group's code path, bit for bit ------


@pytest.fixture
def world1(tmp_path):
    """A one-rank gloo group in this process (file rendezvous under
    tmp_path, no port), destroyed afterwards."""
    n = multihost.initialize_cluster("file://" + str(tmp_path / "pg"), 1, 0, device="cpu",
                                     timeout=60)
    assert n == 1
    try:
        yield TP.global_mesh()
    finally:
        multihost.shutdown()


def _bits(a, b):
    a, b = torch.as_tensor(a), torch.as_tensor(b)
    return a.shape == b.shape and torch.equal(a.view(torch.int64) if a.dtype == torch.float64
                                              else a, b.view(torch.int64)
                                              if b.dtype == torch.float64 else b)


def _same_bits(res, ref, names=("xopt", "zopt", "uopt")):
    assert res.steps == ref.steps
    for name in names:
        assert torch.equal(getattr(res, name), getattr(ref, name)), name
    for key, h in ref.hist.items():
        assert torch.equal(res.hist[key].nan_to_num(7.0), h.nan_to_num(7.0)), key


@pytest.mark.parametrize("kw", [{}, dict(fast=True), dict(anderson=3), dict(relax=1.5)])
def test_world1_group_consensus_equals_stacked_bit_for_bit(world1, kw):
    D, s = _lasso()
    cfg = T.ADMMConfig(maxiters=400, **kw)
    ref = TP.consensus_lasso(D, s, 0.3, cfg, mesh=_stacked(8), nshards=8)
    mesh8 = TP.make_mesh(8, group=world1.group)
    res = TP.consensus_lasso(D, s, 0.3, cfg, mesh=mesh8, nshards=8)
    _same_bits(res, ref)
    assert torch.equal(res.extra["xi"], ref.extra["xi"])
    assert mesh8.stats["calls"]["all_reduce"] == (4 if kw.get("anderson") else 2) * res.steps


def test_world1_group_other_runners_equal_stacked_bit_for_bit(world1):
    rng = np.random.default_rng(5)
    D, s = _lasso()
    cfg = T.ADMMConfig(maxiters=200)
    g8 = TP.make_mesh(8, group=world1.group)
    _same_bits(TP.linearsvm_sharded(D, np.sign(s), 1.0, cfg, mesh=g8),
               TP.linearsvm_sharded(D, np.sign(s), 1.0, cfg, mesh=_stacked(8)))
    As, bs = rng.standard_normal((8, 12, 6)), rng.standard_normal((8, 12))
    _same_bits(TP.exchange_quadratic(As, bs, cfg, mesh=g8),
               TP.exchange_quadratic(As, bs, cfg, mesh=_stacked(8)))
    C, A, b, *_ = random_sdp_instance(6, 10, 2, rng)
    g4 = TP.make_mesh(4, group=world1.group)
    _same_bits(TP.sdp_sharded(C, A, b, cfg, mesh=g4),
               TP.sdp_sharded(C, A, b, cfg, mesh=_stacked(4)))
    Dc = rng.standard_normal((64, 6))
    _same_bits(TP.consensus_covsel(Dc, 0.1, cfg, mesh=g4),
               TP.consensus_covsel(Dc, 0.1, cfg, mesh=_stacked(4)))


def test_world1_group_sliced_prox_gathers_the_blocks(world1):
    W, n = 4, 19
    lengths = slicemaker(0, n, W)
    starts = np.concatenate([[0], np.cumsum(lengths)[:-1]])
    L = max(lengths)

    def prox_slice(x, z, u, rho, k):
        v = torch.nn.functional.pad(z - u, (0, L))
        return v[int(starts[k]):int(starts[k]) + L] * rho

    mesh = TP.make_mesh(W, group=world1.group)
    prox = TP.make_sliced_prox(prox_slice, lengths, mesh)
    gen = torch.Generator().manual_seed(0)
    z, u = (torch.randn(n, generator=gen, dtype=torch.float64) for _ in range(2))
    assert torch.equal(prox(z, z, u, 1.5), 1.5 * (z - u))
    assert mesh.stats["calls"] == {"all_gather": 1}
    assert mesh.stats["bytes"] == {"all_gather": W * L * F64}


def test_world1_group_lanes_gather_once(world1):
    D, s = _lasso()
    S = np.stack([s, -s, 0.5 * s, 2 * s])
    cfg = T.ADMMConfig(maxiters=300)
    mesh = TP.make_mesh2d(2, 2, group=world1.group)
    res = TP.consensus_lasso_batch(D, S, 0.3, cfg, mesh=mesh, nshards=4)
    ref = TP.consensus_lasso_batch(D, S, 0.3, cfg, mesh=TP.make_mesh2d(2, 2, device="cpu"),
                                   nshards=4)
    assert res.steps.tolist() == ref.steps.tolist()
    assert torch.equal(res.zopt, ref.zopt) and torch.equal(res.extra["xi"], ref.extra["xi"])
    assert mesh.stats["calls"] == {"all_gather": 1}


def test_initialize_cluster_without_a_cluster_joins_nothing():
    # One process and no coordinator: nothing is joined (admm_tpu's no-op)
    # and the count is the visible devices'.
    assert multihost.initialize_cluster(device="cpu") == 1
    assert not torch.distributed.is_initialized()
    assert TP.global_mesh.__module__.endswith("multihost")


def test_mesh_over_a_group_checks_its_divisions(world1):
    with pytest.raises(ValueError, match="fewer than"):
        TP.consensus_lasso(*_lasso(), 0.3, mesh=TP.make_mesh(2, group=world1.group),
                           nshards=1)
    assert TP.make_mesh(group=world1.group).shape == (1,)
    assert TP.make_mesh(group=world1.group).device == torch.device("cpu")


def test_group_made_outside_initialize_cluster_stays_off_the_cpu(tmp_path, monkeypatch):
    # A gloo group made with torch.distributed directly (as under torchrun
    # with the caller's own init_process_group): no device was recorded,
    # so a mesh over it without device= takes the card, and raises where
    # there is none; the CPU only when asked for.
    import datetime

    import torch.distributed as dist

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    dist.init_process_group("gloo", init_method="file://" + str(tmp_path / "pg"), world_size=1,
                            rank=0, timeout=datetime.timedelta(seconds=60))
    try:
        with pytest.raises(RuntimeError, match='device="cpu"'):
            TP.global_mesh()
        with pytest.raises(RuntimeError, match='device="cpu"'):
            TP.make_mesh(8, group=dist.group.WORLD)
        mesh = TP.make_mesh(8, group=dist.group.WORLD, device="cpu")
        assert mesh.device == torch.device("cpu") and mesh.world == 1
        D, s = _lasso()
        cfg = T.ADMMConfig(maxiters=100)
        _same_bits(TP.consensus_lasso(D, s, 0.3, cfg, mesh=mesh, nshards=8),
                   TP.consensus_lasso(D, s, 0.3, cfg, mesh=_stacked(8), nshards=8))
    finally:
        multihost.shutdown()
