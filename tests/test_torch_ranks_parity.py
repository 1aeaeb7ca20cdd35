"""Each sharded runner of the port over two processes (one gloo group on
the CPU, each rank holding its block of 8 shards, f64) against the
port's stacked run and admm_tpu's run on its 8-device CPU mesh.

One two-rank session (a module fixture) runs every case once and each
rank saves what it got.  For every case: both ranks took the same steps
and hold the same bits in every history (their stop decisions come only
from all-reduced values); the steps equal the stacked run's and
admm_tpu's; the iterates and histories agree with both within
tests/_parity.py's bar (1e-9 of the largest entry; histories 1e-8 of the
first value).  The modes that ROADMAP.md queue 3 records as sensitive to
the last bit of a reduction (the accelerated restarts, the fast mode of
the SVM, which does not converge at this size) compare a prefix of their
histories instead, as tests/test_torch_exchange.py does."""

import numpy as np
import pytest
import torch

import admm_tpu as J
import admm_tpu.parallel as JP
import admm_tpu_torch as T
import admm_tpu_torch.parallel as TP
from _torch_rank_cases import BASE, CASES, W, _data
from _torch_ranks import check, run_ranks

torch.set_num_threads(1)
WORKER = '''
import admm_tpu_torch as P
from admm_tpu_torch.parallel import make_mesh, make_mesh2d
import _torch_rank_cases as M
d = M._data()
g8 = make_mesh(M.W, group=mesh.group)
out = {}
for name, (expr, kw, _) in M.CASES.items():
    cfg = P.ADMMConfig(**dict(M.BASE, **kw))
    res = eval(expr, dict(P=P.parallel, d=d, cfg=cfg, mesh=g8, np=np))
    out[name + ".steps"] = res.steps
    for f in ("xopt", "zopt", "uopt"):
        out[name + "." + f] = getattr(res, f)
    for h, v in res.hist.items():
        out[name + ".hist." + h] = v
lanes = P.ADMMConfig(maxiters=2000)
b = P.parallel.consensus_lasso_batch(d["D"], d["S"], 0.6, lanes,
                                     mesh=make_mesh2d(2, 2, group=mesh.group), nshards=4)
out.update({"batch2d.steps": b.steps, "batch2d.zopt": b.zopt, "batch2d.xi": b.extra["xi"],
            "batch2d.hist.pnorm": b.hist["pnorm"]})
lb = P.lasso_batch(d["D"], d["S"], 0.6, lanes, mesh=make_mesh(2, group=mesh.group),
                   device="cpu")
out.update({"lasso_batch.steps": lb.steps, "lasso_batch.zopt": lb.zopt,
            "lasso_batch.hist.pnorm": lb.hist["pnorm"]})
save(**out)
'''


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("ranks")
    got = run_ranks(WORKER, tmp, timeout=240)
    check(*got)
    return got[3]


def _port(name):
    expr, kw, _ = CASES[name]
    cfg = T.ADMMConfig(**dict(BASE, **kw))
    return eval(expr, dict(P=TP, d=_data(), cfg=cfg, mesh=TP.make_mesh(W, device="cpu"),
                           np=np))


def _jax(name):
    expr, kw, _ = CASES[name]
    cfg = J.ADMMConfig(**dict(BASE, **kw))
    return eval(expr, dict(P=JP, d=_data(), cfg=cfg, mesh=JP.make_mesh(W), np=np))


def _hist_names(r):
    return sorted(k.split(".hist.")[1] for k in r if ".hist." in k)


def _close(got, ref, rtol=1e-9):
    ref = np.asarray(ref, dtype=np.float64)
    scale = np.max(np.abs(ref)) if ref.size else 0.0
    np.testing.assert_allclose(got, ref, rtol=rtol, atol=rtol * scale)


def _same_ranks(r0, r1, name):
    keys = [k for k in r0 if k.startswith(name + ".")]
    assert keys
    for k in keys:
        a, b = r0[k], r1[k]
        assert a.shape == b.shape, k
        if a.dtype.kind == "f":
            assert np.array_equal(a.view(np.int64), b.view(np.int64)), k
        else:
            assert np.array_equal(a, b), k


@pytest.mark.parametrize("name", sorted(CASES))
def test_ranks_agree_with_stacked_and_admm_tpu(ranks, name):
    r0, r1 = ranks
    _same_ranks(r0, r1, name)
    steps = int(r0[name + ".steps"])
    prefix_only = CASES[name][2]
    refs = [_port(name), _jax(name)]
    for ref in refs:
        ref_steps = int(ref.steps)
        if prefix_only:
            k = min(steps, ref_steps, 40)
            for h in ("pnorm", "dnorm"):
                got = r0[f"{name}.hist.{h}"][:k]
                want = np.asarray(ref.hist[h])[:k] if not hasattr(ref.hist[h], "numpy") \
                    else ref.hist[h][:k].numpy()
                scale = abs(want[0]) or np.max(np.abs(want))
                np.testing.assert_allclose(got, want, rtol=0, atol=1e-8 * scale)
            continue
        assert steps == ref_steps, (steps, ref_steps)
        zscale = np.max(np.abs(np.asarray(ref.zopt)))
        for f in ("xopt", "zopt", "uopt"):
            want = np.asarray(getattr(ref, f))
            scale = max(np.max(np.abs(want)), zscale if f == "uopt" else 0.0)
            np.testing.assert_allclose(r0[f"{name}.{f}"], want, rtol=1e-9, atol=1e-9 * scale)
        for h in ("pnorm", "dnorm"):
            want = np.asarray(ref.hist[h])[:steps]
            got = r0[f"{name}.hist.{h}"][:steps]
            if np.isnan(want).all():
                assert np.isnan(got).all()
                continue
            scale = abs(want[0]) or np.max(np.abs(want))
            np.testing.assert_allclose(got, want, rtol=0, atol=1e-8 * scale)


def test_lanes_over_ranks_equal_the_stacked_lanes(ranks):
    r0, r1 = ranks
    d = _data()
    lanes = T.ADMMConfig(maxiters=2000)
    ref = TP.consensus_lasso_batch(d["D"], d["S"], 0.6, lanes,
                                   mesh=TP.make_mesh2d(2, 2, device="cpu"), nshards=4)
    jref = JP.consensus_lasso_batch(d["D"], d["S"], 0.6, J.ADMMConfig(maxiters=2000),
                                    mesh=JP.make_mesh2d(2, 4), nshards=4)
    for name in ("batch2d", "lasso_batch"):
        _same_ranks(r0, r1, name)
    assert r0["batch2d.steps"].tolist() == ref.steps.tolist() == np.asarray(jref.steps).tolist()
    _close(r0["batch2d.zopt"], ref.zopt.numpy())
    _close(r0["batch2d.zopt"], np.asarray(jref.zopt))
    _close(r0["batch2d.xi"], ref.extra["xi"].numpy())
    lb = T.lasso_batch(d["D"], d["S"], 0.6, lanes, device="cpu")
    assert r0["lasso_batch.steps"].tolist() == lb.steps.tolist()
    _close(r0["lasso_batch.zopt"], lb.zopt.numpy())
