"""Lanes x shards meshes whose shard axis crosses ranks
(``parallel.mesh.make_mesh2d`` over a process group, laid out as
``admm_tpu``'s process-major device grid).

Four gloo ranks on a 2 x 4 mesh (each lane row's shards over a subgroup
of two ranks: tests/test_parallel.py's ``make_mesh2d(2, 4)`` case) and two
gloo ranks on a 1 x 8 mesh (each rank 4 of every lane's 8 shards), each
running ``consensus_lasso_batch``, ``consensus_elasticnet_batch``,
``consensus_covsel_batch`` and ``svm_batch_sharded`` once (a module
fixture per rank count): every rank holds the same bits, and every result
equals the stacked run on the same mesh shape (equal steps, 1e-10) and
``admm_tpu``'s on its 8 CPU devices (equal steps, 1e-10).  The call with
no mesh over two ranks takes ``admm_tpu``'s default, 1 lane x every
device, with the shard axis over the ranks.  In this process, over a
one-rank gloo group: a shard-axis reduction under ``torch.func.vmap`` is
one collective whatever the lane count.  f64."""

import numpy as np
import pytest
import torch

import admm_tpu as J
import admm_tpu.parallel as JP
import admm_tpu_torch as T
import admm_tpu_torch.parallel as TP
from admm_tpu_torch.parallel import multihost
from _torch_ranks import check, run_ranks, same_on_every_rank

torch.set_num_threads(1)

# name -> runner expression over a package P, its mesh ``mesh`` and data ``d``.
CASES = {
    "lasso": "P.consensus_lasso_batch(d['D'], d['S'], d['lams'], cfg(maxiters=500), mesh=mesh, "
             "nshards=8)",
    "elasticnet": "P.consensus_elasticnet_batch(d['D'], d['S'], d['lams'], 0.6, "
                  "cfg(maxiters=500), mesh=mesh, nshards=8)",
    "covsel": "P.consensus_covsel_batch(d['Ds'], d['lams'], cfg(maxiters=300, abstol=1e-8, "
              "reltol=1e-8), mesh=mesh, nshards=8)",
    "svm": "P.svm_batch_sharded(d['D'], d['ells'], 1.0, cfg(maxiters=300), mesh=mesh, "
           "nshards=8, x0=np.zeros((4, 10)), z0=d['z0'], u0=d['z0'])",
}
FIELDS = {"lasso": ("zopt", "xopt", "uopt", "xi"), "elasticnet": ("zopt", "xopt", "xi"),
          "covsel": ("zopt", "xopt", "xi"), "svm": ("xopt", "zopt", "uopt", "objopt")}


def _data():
    # tests/test_parallel.py:871-880's lanes, with labels and covariance
    # samples beside them.
    rng = np.random.default_rng(5)
    m, n, B = 64, 10, 4
    D = rng.standard_normal((m, n))
    return dict(D=D, S=rng.standard_normal((B, m)), lams=np.geomspace(0.05, 0.4, B),
                ells=np.sign(rng.standard_normal((B, m))), z0=rng.standard_normal((B, m)),
                Ds=rng.standard_normal((B, 48, 5)))


def _fields(res, name):
    out = {"steps": res.steps}
    for f in FIELDS[name]:
        out[f] = res.extra[f] if f == "xi" else getattr(res, f)
    out["pnorm"] = res.hist["pnorm"]
    return out


WORKER = '''
import admm_tpu_torch as P0
import admm_tpu_torch.parallel as P
import test_torch_lanes_ranks as M
from admm_tpu_torch.parallel import make_mesh2d
d = M._data()
cfg = lambda **kw: P0.ADMMConfig(**kw)
m2 = make_mesh2d(*SHAPE, group=mesh.group)
out = {}
for name, expr in M.CASES.items():
    m2.reset_stats()
    res = eval(expr, dict(P=P, d=d, cfg=cfg, mesh=m2, np=np))
    st = m2.reset_stats()
    for f, v in M._fields(res, name).items():
        out[name + "." + f] = v
    out[name + ".calls"] = np.array([st["calls"].get("all_reduce", 0),
                                     st["calls"].get("all_gather", 0)])
EXTRA
save(**out)
'''

DEFAULT = '''
res = P.consensus_lasso_batch(d["D"], d["S"], d["lams"], cfg(maxiters=500))
m = res.extra["mesh"]
out.update({"default." + f: v for f, v in M._fields(res, "lasso").items()})
out["default.shape"] = np.array(m.shape + (m.world, m.span, res.extra["nshards"]))
for bad in ((3, 4), (1, 3)):
    try:
        make_mesh2d(*bad, group=mesh.group)
        out["refused.%dx%d" % bad] = 0
    except ValueError as e:
        out["refused.%dx%d" % bad] = int("lanes must divide the ranks" in str(e))
'''


def _ranks(tmp_path_factory, procs, shape, extra=""):
    tmp = tmp_path_factory.mktemp(f"lanes{procs}")
    code = WORKER.replace("SHAPE", repr(shape)).replace("EXTRA", extra)
    got = run_ranks(code, tmp, procs=procs, timeout=240)
    check(*got)
    same_on_every_rank(got[3])
    return got[3][0]


@pytest.fixture(scope="module")
def four_ranks(tmp_path_factory):
    return _ranks(tmp_path_factory, 4, (2, 4))


@pytest.fixture(scope="module")
def two_ranks(tmp_path_factory):
    return _ranks(tmp_path_factory, 2, (1, 8), DEFAULT)


def _close(got, ref, bar=1e-10):
    ref = np.asarray(ref, dtype=np.float64)
    np.testing.assert_allclose(got, ref, rtol=bar, atol=bar * max(np.max(np.abs(ref)), 1.0))


def _hold(r, prefix, name, port, jax):
    steps = r[prefix + ".steps"].tolist()
    assert steps == port.steps.tolist() == np.asarray(jax.steps).tolist()
    for f, want in _fields(port, name).items():
        if f == "steps":
            continue
        got = r[f"{prefix}.{f}"]
        if f == "pnorm":
            for b, k in enumerate(steps):
                _close(got[b, :k], want[b, :k].numpy())
            continue
        _close(got, want.numpy())
        jwant = (jax.extra[f] if f == "xi" else getattr(jax, f))
        _close(got, np.asarray(jwant))


@pytest.mark.parametrize("procs,shape", [(4, (2, 4)), (2, (1, 8))])
@pytest.mark.parametrize("name", sorted(CASES))
def test_lanes_over_subgroups_equal_stacked_and_admm_tpu(request, procs, shape, name):
    r = request.getfixturevalue("four_ranks" if procs == 4 else "two_ranks")
    d = _data()
    port = eval(CASES[name], dict(P=TP, d=d, cfg=lambda **kw: T.ADMMConfig(**kw), np=np,
                                  mesh=TP.make_mesh2d(*shape, device="cpu")))
    jax = eval(CASES[name], dict(P=JP, d=d, cfg=lambda **kw: J.ADMMConfig(**kw), np=np,
                                 mesh=JP.make_mesh2d(*shape)))
    _hold(r, name, name, port, jax)
    # Every sub-step's shard-axis reductions are collectives over the lane
    # row's subgroup, one each for all the lanes of the row; each chunk's
    # flags one more over the whole group; one all_gather of the results.
    reduce, gather = r[name + ".calls"].tolist()
    assert gather == 1 and reduce >= 2 * int(max(r[name + ".steps"]))


def test_default_mesh_puts_the_shard_axis_over_the_ranks(two_ranks):
    # consensus_lasso_batch(D, S, lams) with no mesh, on every rank of two:
    # 1 lane x 2 positions, a lane row over both ranks, W = 2 shards; equal
    # to the stacked make_mesh2d(1, 2) run and admm_tpu's on 2 devices.
    r = two_ranks
    assert r["default.shape"].tolist() == [1, 2, 2, 2, 2]
    d = _data()
    cfg = dict(maxiters=500)
    port = TP.consensus_lasso_batch(d["D"], d["S"], d["lams"], T.ADMMConfig(**cfg),
                                    mesh=TP.make_mesh2d(1, 2, device="cpu"))
    jax = JP.consensus_lasso_batch(d["D"], d["S"], d["lams"], J.ADMMConfig(**cfg),
                                   mesh=JP.make_mesh2d(1, 2))
    _hold(r, "default", "lasso", port, jax)


def test_layouts_off_the_process_grid_are_refused(two_ranks):
    # 3 lanes over 2 ranks, and 1 x 3 (2 ranks do not divide 3 shards).
    assert two_ranks["refused.3x4"] == 1 and two_ranks["refused.1x3"] == 1


@pytest.fixture
def world1(tmp_path):
    assert multihost.initialize_cluster("file://" + str(tmp_path / "pg"), 1, 0, device="cpu",
                                        timeout=60) == 1
    try:
        yield TP.global_mesh()
    finally:
        multihost.shutdown()


@pytest.mark.parametrize("lanes", [1, 4, 16])
def test_a_vmapped_reduction_is_one_collective(world1, monkeypatch, lanes):
    # Mesh.psum and Mesh.pmean under torch.func.vmap over a one-rank gloo
    # group: one all_reduce of the whole (B, ...) payload a call, counted
    # once in Mesh.stats with every lane's bytes, whatever B; the values
    # are the stacked mesh's.
    import torch.distributed as dist

    mesh = TP.make_mesh(4, group=world1.group)
    calls = []
    real = dist.all_reduce

    def spy(t, *a, **kw):
        calls.append(tuple(t.shape))
        return real(t, *a, **kw)

    monkeypatch.setattr(dist, "all_reduce", spy)
    x = torch.randn(lanes, 4, 3, dtype=torch.float64)

    def f(xi):
        xbar = mesh.pmean(xi)
        a, b = mesh.psum(torch.sum(xi * xi), xi[0])
        return xbar, a, b

    xbar, a, b = torch.func.vmap(f)(x)
    assert calls == [(lanes, 3), (lanes, 4)]
    assert mesh.stats["calls"] == {"all_reduce": 2}
    assert mesh.stats["bytes"] == {"all_reduce": lanes * 3 * 8 + lanes * 4 * 8}
    assert torch.equal(xbar, x.mean(dim=1)) and torch.equal(b, x[:, 0])
    assert torch.equal(a, torch.sum(x * x, dim=(1, 2)))
    # Under vmap of a differentiated reduction too: one collective forward.
    calls.clear()
    g = torch.func.vmap(torch.func.grad(lambda xi: mesh.psum(torch.sum(xi ** 3), grad=True)))(x)
    assert calls[0] == (lanes, 1) and torch.equal(g, 3 * x ** 2)
