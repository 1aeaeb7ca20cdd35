"""``consensus_lasso`` given each rank's own rows, over processes and
stacked, on the CPU in float64.

One four-rank gloo session (8 shards of 24 x 40 fat rows, two a rank)
runs the whole-matrix call, the rank-local call (each rank given only
its block of D and s) and the benchmark's plain reference
(``perfbench/reference/consensus_lasso.py``: its own Woodbury solve, its
sums through plain ``all_reduce``), each rank saving what it got.  The
two forms of the port agree bit for bit, every rank holds the same bits,
and the port equals the reference to 1e-10 at the same step count.  One
two-rank session traces a solve: it records the consensus spans, and one
``collective`` span for each collective ``Mesh.stats`` counts.  In one
process: the rank-local form on a stacked mesh, and the shapes refused."""

from pathlib import Path

import numpy as np
import pytest
import torch

import admm_tpu_torch.parallel as TP
from admm_tpu_torch import ADMMConfig
from _torch_ranks import check, run_ranks, same_on_every_rank

torch.set_num_threads(1)
PERFBENCH = str(Path(__file__).resolve().parents[1] / "perfbench")
W, MI, N = 8, 24, 40


def _data(seed=0):
    rng = np.random.default_rng(seed)
    D = rng.standard_normal((W * MI, N))
    D /= np.linalg.norm(D, axis=0)
    s = D @ (rng.standard_normal(N) * (rng.random(N) < 0.2)) + 0.03 * rng.standard_normal(W * MI)
    return D, s, 0.1 * float(np.max(np.abs(D.T @ s)))


WORKER = """
sys.path.insert(0, PERFBENCH)
from reference.consensus_lasso import admm_consensus_lasso
from test_torch_consensus_ranks import _data, W, MI, N
import admm_tpu_torch.parallel as TP
from admm_tpu_torch import ADMMConfig
D, s, lam = _data()
cfg = ADMMConfig(maxiters=1000, abstol=1e-8, reltol=1e-6)
rows = slice(rank * MI * W // ranks, (rank + 1) * MI * W // ranks)
Dloc = torch.from_numpy(D[rows]).reshape(W // ranks, MI, N)
sloc = torch.from_numpy(s[rows]).reshape(W // ranks, MI)
runs = {"whole": TP.consensus_lasso(D, s, lam, cfg, mesh=mesh, nshards=W),
        "local": TP.consensus_lasso(Dloc, sloc, lam, cfg, mesh=mesh),
        "net": TP.consensus_elasticnet(Dloc, sloc, lam, 0.3, cfg, mesh=mesh),
        "net_whole": TP.consensus_elasticnet(D, s, lam, 0.3, cfg, mesh=mesh, nshards=W)}
x, z, u, own = admm_consensus_lasso(Dloc, sloc, lam, W, rho=1.0, abstol=1e-8, reltol=1e-6,
                                    maxiters=1000, stop_at=[runs["local"].steps],
                                    group=mesh.group)
out = {name + "." + f: getattr(r, f) for name, r in runs.items()
       for f in ("xopt", "zopt", "uopt", "steps")}
out.update({"local.xi": runs["local"].extra["xi"], "whole.xi": runs["whole"].extra["xi"],
            "ref.x": x[0], "ref.z": z[0], "ref.u": u[0], "ref.own": own[0]})
save(**out)
""".replace("PERFBENCH", repr(PERFBENCH))


@pytest.fixture(scope="module")
def four(tmp_path_factory):
    got = run_ranks(WORKER, tmp_path_factory.mktemp("four"), procs=4, timeout=120)
    check(*got)
    return got[3]


def test_rank_local_rows_give_the_whole_calls_bits(four):
    same_on_every_rank(four)
    r = four[0]
    for name, other in (("local", "whole"), ("net", "net_whole")):
        for f in ("xopt", "zopt", "uopt", "steps"):
            assert r[f"{name}.{f}"].tobytes() == r[f"{other}.{f}"].tobytes(), (name, f)
    assert r["local.xi"].shape == (W, N)
    assert r["local.xi"].tobytes() == r["whole.xi"].tobytes()


def test_port_equals_the_plain_reference(four):
    r = four[0]
    assert int(r["ref.own"]) == int(r["local.steps"])
    for f, g in (("xopt", "x"), ("zopt", "z"), ("uopt", "u")):
        np.testing.assert_allclose(r[f"local.{f}"], r[f"ref.{g}"], rtol=0, atol=1e-10)
    assert np.linalg.norm(r["local.zopt"]) > 0.1


SPAN_WORKER = '''
import json
from admm_tpu_torch import ADMMConfig
from admm_tpu_torch.utils import profiling
import admm_tpu_torch.parallel as TP
from test_torch_consensus_ranks import _data, W, MI, N
D, s, lam = _data(1)
rows = slice(rank * MI * W // ranks, (rank + 1) * MI * W // ranks)
Dloc = torch.from_numpy(D[rows]).reshape(W // ranks, MI, N)
sloc = torch.from_numpy(s[rows]).reshape(W // ranks, MI)
mesh.reset_stats()
with profiling.trace(f"{_out}/trace{rank}"):
    res = TP.consensus_lasso(Dloc, sloc, lam, ADMMConfig(maxiters=300, unroll=4), mesh=mesh)
with open(f"{_out}/trace{rank}/trace.json") as f:
    events = json.load(f)["traceEvents"]
names = [e["name"][len("admm_tpu_torch."):] for e in sorted(
    (e for e in events if e.get("ph") == "X" and e.get("name", "").startswith("admm_tpu_torch.")),
    key=lambda e: float(e["ts"]))]
save(steps=res.steps, names=np.array(names),
     stats=sum(mesh.stats["calls"].values()))
'''


def test_consensus_solve_records_its_spans(tmp_path):
    got = run_ranks(SPAN_WORKER, tmp_path, procs=2, timeout=120)
    check(*got)
    for r in got[3]:
        names = list(r["names"])
        counts = {n: names.count(n) for n in set(names)}
        assert {"setup", "prepare", "loop", "chunk", "step", "step.xupdate", "step.tail",
                "collective", "result"} <= set(counts)
        assert counts["setup"] == counts["prepare"] == counts["loop"] == counts["result"] == 1
        assert counts["collective"] == int(r["stats"])
        # two collectives a sub-step, the result's gather after the loop
        assert counts["collective"] == 2 * counts["step"] + 1
        assert counts["step.xupdate"] == counts["step.tail"] == counts["step"]
        assert counts["step"] == 4 * counts["chunk"] >= int(r["steps"])
        order = [n for n in names if n in ("setup", "prepare", "loop", "result")]
        assert order == ["setup", "prepare", "loop", "result"]


def test_rank_local_form_on_a_stacked_mesh():
    D, s, lam = _data()
    cfg = ADMMConfig(maxiters=1000)
    whole = TP.consensus_lasso(D, s, lam, cfg, nshards=W, device="cpu")
    stacked = TP.consensus_lasso(torch.from_numpy(D).reshape(W, MI, N),
                                 torch.from_numpy(s).reshape(W, MI), lam, cfg, device="cpu")
    assert stacked.steps == whole.steps and stacked.extra["nshards"] == W
    for f in ("xopt", "zopt", "uopt"):
        assert torch.equal(getattr(stacked, f), getattr(whole, f))


@pytest.mark.parametrize("shape_D,shape_s,nshards", [
    ((W, MI, N), (W * MI,), None),        # a block of D with the whole s
    ((W * MI, N), (W, MI), None),          # the whole D with a block of s
    ((W, MI, N), (W, MI + 1), None),       # blocks of different rows
    ((W, MI, N), (W, MI), 2 * W),          # more shards than the block holds
    ((1, W, MI, N), (W, MI), None),        # no such form
])
def test_ambiguous_shapes_are_refused(shape_D, shape_s, nshards):
    with pytest.raises(ValueError):
        TP.consensus_lasso(torch.zeros(shape_D, dtype=torch.float64),
                           torch.zeros(shape_s, dtype=torch.float64), 0.1, ADMMConfig(),
                           nshards=nshards, device="cpu")
