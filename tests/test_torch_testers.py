"""The port's randomized tester harness (``admm_tpu_torch/testers``): the
cases of tests/test_testers.py on the CPU (``test_svm_parallel_sweep``
with the SVM tester's parallel case), and each default instance
against admm_tpu's tester on the same seed: the same pass/fail verdict,
equal steps and the oracle's objective or residual to rtol 1e-6.  f64.
"""

import numpy as np
import pytest
import torch

import admm_tpu.testers as jt
from admm_tpu_torch.testers import (
    basispursuittest,
    covarianceselectiontest,
    huberfittest,
    ladtest,
    lassotest,
    linearprogramtest,
    linearsvmtest,
    logregtest,
    make_svm_instance,
    modeltest,
    quadraticprogramtest,
    solvertester,
    totalvariationtest,
)
from admm_tpu_torch.testers.solvertester import _shape

torch.set_num_threads(1)
CPU = dict(quiet=True, device="cpu")

# test_all_problem_testers_pass_default_instances's instances, and the
# oracle value each tester reports.
CASES = [
    ("model", modeltest, jt.modeltest, (0, 64, 64), {}, "xresidual"),
    ("lasso", lassotest, jt.lassotest, (0, 128, 64), {}, "objopt"),
    ("basispursuit", basispursuittest, jt.basispursuittest, (0, 16, 64), {}, "objopt"),
    ("totalvariation", totalvariationtest, jt.totalvariationtest, (0, 128), {}, "objopt"),
    ("lad", ladtest, jt.ladtest, (0, 256, 16), {}, "objopt"),
    ("huberfit", huberfittest, jt.huberfittest, (0, 256, 16), {}, "objopt"),
    ("linearprogram", linearprogramtest, jt.linearprogramtest, (0, 32, 32), {}, "objopt"),
    ("quadraticprogram", quadraticprogramtest, jt.quadraticprogramtest, (0, 32, 32), {},
     "xresidual"),
    ("qp bounded", quadraticprogramtest, jt.quadraticprogramtest, (0, 32, 32),
     {"form": "bounded"}, "xresidual"),
    ("covarianceselection", covarianceselectiontest, jt.covarianceselectiontest, (0, 128, 16),
     {}, "objopt"),
]


@pytest.mark.parametrize("name, ours, ref, args, kw, oracle", CASES, ids=[c[0] for c in CASES])
def test_problem_tester_passes_and_matches_admm_tpu(name, ours, ref, args, kw, oracle):
    res, test = ours(*args, **kw, **CPU)
    assert not test["failed"], (test["solver"], test["failreason"])
    assert res.xopt.device.type == "cpu" and res.xopt.dtype == torch.float64
    jres, jtest = ref(*args, **kw, quiet=True)
    assert res.steps == jres.steps
    np.testing.assert_allclose(test[oracle], jtest[oracle], rtol=1e-6, atol=1e-12)


def test_all_problem_testers_pass_default_instances():
    # tests/test_testers.py's case as one sweep, logregtest beside it.
    checks = [f(*args, **kw, **CPU) for _, f, _, args, kw, _ in CASES]
    checks.append(logregtest(0, **CPU))
    for res, test in checks:
        assert not test["failed"], (test["solver"], test["failreason"])


def test_logreg_tester_matches_admm_tpu():
    res, test = logregtest(0, **CPU)
    jres, jtest = jt.logregtest(0, quiet=True)
    assert not test["failed"] and res.steps == jres.steps
    np.testing.assert_allclose(test["kkt"], jtest["kkt"], rtol=1e-4, atol=1e-9)


def test_svm_tester():
    res_h, res_01, test = linearsvmtest(0, **CPU)
    assert not test["failed"], test["failreason"]
    D, ell = make_svm_instance(0)
    jD, jell = jt.problems.make_svm_instance(0)
    assert np.array_equal(D, jD) and np.array_equal(ell, jell)


def test_svm_tester_parallel_waits_for_slice_10():
    # parallel=True routes both solves through the sharded
    # transpose-reduction path: green, as admm_tpu's parallel tester is
    # (the random starts are each package's own, so the runs are not
    # compared step by step), and through the sweep harness as
    # tests/test_testers.py::test_svm_parallel_sweep does.
    res_h, res_01, test = linearsvmtest(0, parallel=True, nshards=4, **CPU)
    assert not test["failed"], test["failreason"]
    assert not jt.linearsvmtest(0, parallel=True, nshards=4)[2]["failed"]
    assert res_h.extra["nshards"] == res_01.extra["nshards"] == 4
    rep = solvertester("linearsvm", 4, 4, trials=1, seed=0, parallel=True, nshards=4,
                       device="cpu")
    assert not rep.any_failed


def test_solvertester_sweep_deterministic():
    rep1 = solvertester("lasso", 4, 5, 2, seed=0, testtype="skinny", device="cpu")
    rep2 = solvertester("lasso", 4, 5, 2, seed=0, testtype="skinny", device="cpu")
    assert not rep1.any_failed
    np.testing.assert_array_equal(rep1.steps, rep2.steps)
    assert rep1.avetimes.shape == (2,)
    assert "lasso" in rep1.summary()
    ref = jt.solvertester("lasso", 4, 5, 2, seed=0, testtype="skinny")
    np.testing.assert_array_equal(rep1.steps, ref.steps)


def test_solvertester_unknown_solver():
    with pytest.raises(ValueError, match="unknown solver"):
        solvertester("nope", 4, 4, 1)


def test_svm_imbalance_presets():
    mpos, mneg = _shape("linearsvm", 10, "morepos")
    assert mpos < mneg
    mpos, mneg = _shape("linearsvm", 10, "moreneg")
    assert mpos > mneg
    rep = solvertester("linearsvm", 4, 4, trials=1, seed=0, testtype="moreneg", device="cpu")
    assert not rep.any_failed


def test_custom_scaler_handle():
    seen = []

    def scaler(s):
        seen.append(s)
        return (3 * 2**s, 2**s)

    rep = solvertester("lasso", 4, 5, trials=1, seed=0, scaler=scaler, device="cpu")
    assert seen == [4, 5]
    assert not rep.any_failed


def test_imbalance_preset_survives_floor():
    mpos, mneg = _shape("linearsvm", 4, "morepos")
    assert min(mpos, mneg) >= 256
    assert mneg / mpos == 4.0


def test_shapes_equal_admm_tpu():
    from admm_tpu.testers.solvertester import _shape as jshape

    for solver in ("model", "lasso", "basispursuit", "lad", "linearprogram", "linearsvm"):
        for testtype in ("square", "fat", "skinny") + (("morepos", "moreneg")
                                                       if solver == "linearsvm" else ()):
            for scale in (3, 4, 9):
                assert _shape(solver, scale, testtype) == jshape(solver, scale, testtype)


def test_tester_in_float32():
    res, test = lassotest(0, 128, 64, dtype=torch.float32, **CPU)
    assert res.xopt.dtype == torch.float32 and not test["failed"]
