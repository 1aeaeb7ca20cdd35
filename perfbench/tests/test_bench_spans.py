"""The readers of the port's spans on a small canned trace
(``data/canned_trace_spans.json``): one request of two sub-steps, its
set-up, preparation, loop and result marked by ``admm_tpu_torch.*`` spans,
every value below computed by hand from the file.  On the older canned
trace, which has no spans (a program without them), the new readers give
nothing and the others read what they read before."""

from pathlib import Path

import pytest

from benchlib import spans, spec, trace
from benchlib.context import RunData
from benchlib.window import Request
from families import lasso

DATA = Path(__file__).resolve().parent / "data"
NEW = ["loop_idle_pct", "setup_idle_pct", "step_use_pct", "xupdate_launches_per_substep",
       "tail_launches_per_substep"]


def _run(name, steps, failed=False):
    summary = trace.load(str(DATA / name))
    req = Request(0, 0.0, 1.0, len(steps), steps, max(steps), 0.0, failed, traced=True)
    return RunData({"m": 10, "n": 20}, {}, lasso, [req], [req], summary)


@pytest.fixture
def run():
    return _run("canned_trace_spans.json", [2, 1])


def test_spans_paired_with_their_request(run):
    ((req, named),) = spans.by_request(run)
    assert req is run.traced[0]
    assert {k: len(v) for k, v in named.items()} == {
        "setup": 1, "prepare": 1, "loop": 1, "step": 2, "step.xupdate": 2, "step.tail": 2,
        "result": 1}   # the custom op admm_tpu_torch::cr_solve is no span


@pytest.mark.parametrize("name,value", [
    # loop 1120-1400 us; device there 1130-1160, 1165-1170, 1210-1230,
    # 1245-1250, 1262-1264, 1290-1292: 64 of 280 us busy
    ("loop_idle_pct", 100 * (1 - 64 / 280)),
    # set-up start 1010 to loop start 1120; the LU 1030-1080
    ("setup_idle_pct", 100 * (1 - 50 / 110)),
    # lanes of 2 and 1 steps over 2 step spans x 2 instances
    ("step_use_pct", 100 * 3 / 4),
    # 1125, 1135, 1205 (its nested driver launch is the same launch)
    ("xupdate_launches_per_substep", 3 / 2),
    # 1160, 1240 (a memset is no kernel launch)
    ("tail_launches_per_substep", 2 / 2),
])
def test_reader(run, name, value):
    assert spec.metric_module(name).read(run) == pytest.approx(value)


def test_notes(run):
    for name in NEW:
        spec.metric_module(name).read(run)
    notes = "\n".join(run.notes)
    # device time by correlation: 20 + 10 + 20 us (the second GEMV carries
    # its driver launch's id) and 5 + 5 + 2 us (the memset's)
    assert ("step.xupdate per sub-step 1.500 launches, 28.000 us of host, 25.000 us of device"
            in notes)
    assert "step.tail per sub-step 1.000 launches, 40.000 us of host, 6.000 us of device" in notes
    assert "1 loop spans in 1 requests, 1 inside a sync-bracketed engine interval" in notes
    assert "loop spans 280.000 us against the engine intervals' 282.000 us" in notes


def test_gaps_named_by_spans(run):
    gaps = dict(trace.idle_gaps(run.trace))
    assert gaps["admm_tpu_torch.setup"] == pytest.approx(30e-6)
    assert gaps["admm_tpu_torch.prepare"] == pytest.approx(50e-6)
    assert gaps["admm_tpu_torch.step.tail"] == pytest.approx((40 + 15 + 12) * 1e-6)
    assert gaps["admm_tpu_torch.step"] == pytest.approx(26e-6)
    assert gaps["cudaLaunchKernel"] == pytest.approx(5e-6)
    assert gaps["host: python"] == pytest.approx(708e-6)


def test_failed_request_is_left_out():
    run = _run("canned_trace_spans.json", [2, 1], failed=True)
    assert spans.by_request(run) == []
    assert all(spec.metric_module(n).read(run) is None for n in NEW)


def test_trace_without_spans():
    # A program without spans: the new readers give nothing; the existing
    # readers and the breakdown read the older canned trace as before.
    run = _run("canned_trace.json", [4])
    assert all(spec.metric_module(n).read(run) is None for n in NEW)
    assert run.notes == []
    assert spec.metric_module("launches_per_step").read(run) == pytest.approx(3 / 4)
    assert spec.metric_module("syncs_per_step").read(run) == pytest.approx(1 / 4)
    assert spec.metric_module("device_idle_pct").read(run) == pytest.approx(100 * (1 - 90 / 1000))
    gaps = dict(trace.idle_gaps(run.trace))
    assert gaps["aten::to"] == pytest.approx(592e-6)
    assert sum(gaps.values()) == pytest.approx(910e-6)
