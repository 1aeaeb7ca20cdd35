"""The port's mesh examples and dry run against admm_tpu's: the
unwrapped-ADMM benchmark (the sharded separator at the serial one),
``distributed_matrix`` (the bars of
tests/test_examples.py::test_distributed_matrix_example, and each number
at admm_tpu's demo), ``consensus_hypergradient`` (its history at
admm_tpu's, 1e-8), ``multihost_smoke`` (two spawned gloo ranks) and
``parallel.dryrun`` on 8 stacked shards and over two processes."""

import numpy as np
import pytest
import torch

from admm_tpu_torch.examples import distributed_matrix, hypergradient, multihost_smoke
from admm_tpu_torch.examples import unwrappedadmmtest
from admm_tpu_torch.parallel import dryrun, make_mesh

from _torch_ranks import check, run_ranks

torch.set_num_threads(1)


def test_unwrappedadmmtest_separators_agree():
    out = unwrappedadmmtest.unwrappedadmmtest(scales=(6, 7), quiet=True, device="cpu")
    assert set(out) == {6, 7}
    for serial_t, par_t, gap in out.values():
        assert serial_t > 0 and par_t > 0
        assert gap < 1e-6, gap


def test_distributed_matrix_example():
    from examples.distributed_matrix import demo as j_demo

    out = distributed_matrix.demo(n=9, m=9, p=10, samples=120, quiet=True, device="cpu")
    assert out["sdp"]["max_dev_vs_serial"] <= 1e-8
    assert out["sdp"]["max_dev_vs_opt"] <= 1e-3
    assert out["covsel"]["obj_gap"] <= 1e-5 * (1 + abs(out["covsel"]["obj_serial"]))
    ref = j_demo(n=9, m=9, p=10, samples=120, quiet=True)
    assert out["sdp"]["steps"] == ref["sdp"]["steps"]
    assert out["covsel"]["steps"] == ref["covsel"]["steps"]
    np.testing.assert_allclose(out["covsel"]["obj_consensus"], ref["covsel"]["obj_consensus"],
                               rtol=1e-9)


def test_consensus_hypergradient_improves_val_mse():
    from examples.hypergradient import consensus_hypergradient as j_hg

    hist = hypergradient.consensus_hypergradient(m=256, n=12, steps=6, quiet=True,
                                                 device="cpu")
    lams, mses = [h[0] for h in hist], [h[1] for h in hist]
    assert lams[-1] < 0.5 * lams[0]
    assert mses[-1] < 0.8 * mses[0]
    np.testing.assert_allclose(np.array(hist), np.array(j_hg(m=256, n=12, steps=6,
                                                             quiet=True)), rtol=1e-8)


def test_multihost_smoke_two_ranks():
    assert multihost_smoke.main(procs=2, local_devices=2, device="cpu", timeout=120) == 0


def test_multihost_smoke_defaults_to_the_card(monkeypatch):
    # No device: the card, which raises where none is visible; more NCCL
    # ranks than cards raise and name --backend gloo before any rank starts.
    import admm_tpu_torch.device as D

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        multihost_smoke.main(procs=2)
    monkeypatch.setattr(D, "resolve_device", lambda device, *a: torch.device("cuda"))
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(ValueError, match="--backend gloo"):
        multihost_smoke.main(procs=2)


def test_dryrun_on_stacked_shards():
    out = dryrun.dryrun(8, device="cpu")
    assert out["consensus"]["steps"] > 0 and out["sdp"]["max_dev"] < 1e-8
    assert out["consensus_anderson"]["steps"] <= out["consensus"]["steps"]


def test_dryrun_over_two_processes(tmp_path):
    rc, init, out, res = run_ranks('''
        from admm_tpu_torch.parallel import dryrun, make_mesh
        got = dryrun.dryrun(mesh=make_mesh(8, group=mesh.group))
        save(consensus=got["consensus"]["objective"], steps=got["consensus"]["steps"],
             grad=got["hypergradient"])
    ''', tmp_path)
    check(rc, init, out)
    ref = dryrun.dryrun(mesh=make_mesh(8, device="cpu"))
    for r in res:
        assert int(r["steps"]) == ref["consensus"]["steps"]
        np.testing.assert_allclose(float(r["consensus"]), ref["consensus"]["objective"],
                                   rtol=1e-5)
        np.testing.assert_allclose(float(r["grad"]), ref["hypergradient"], rtol=1e-4)
