"""The trace readers on a small canned trace (``data/canned_trace.json``):
one request whose engine loop lies between its first two device syncs."""

from pathlib import Path

import pytest

from benchlib import trace
from benchlib.context import RunData
from benchlib.window import Request
from families import lasso

CANNED = Path(__file__).resolve().parent / "data" / "canned_trace.json"


@pytest.fixture
def summary():
    return trace.load(str(CANNED))


def _run(summary, steps):
    req = Request(0, 0.0, 1.0, len(steps), steps, max(steps), 0.0, False, traced=True)
    return RunData({"m": 10, "n": 20}, {}, lasso, [req], [req], summary)


def test_engine_window_between_the_first_two_device_syncs(summary):
    assert len(summary.requests) == 1
    assert summary.engine == [pytest.approx((1110e-6, 1300e-6, 1310e-6))]


def test_launches_and_syncs_in_the_loop(summary):
    # two recorded launches (the nested driver call is the same launch),
    # plus the K4 kernel whose launch the trace did not record
    assert summary.launch_count() == 3
    assert summary.sync_count() == 1


def test_metric_readers(summary):
    from benchlib import spec

    run = _run(summary, [4])
    assert spec.metric_module("launches_per_step").read(run) == pytest.approx(3 / 4)
    assert spec.metric_module("syncs_per_step").read(run) == pytest.approx(1 / 4)
    idle = spec.metric_module("device_idle_pct").read(run)
    assert idle == pytest.approx(100 * (1 - 90 / 1000))
    xu = spec.metric_module("xupdate_roofline").read(run)
    from benchlib import roofline as rl
    least = (rl.fat_lasso_xupdate(10, 20) * 4 + rl.gemv(10, 20)).seconds
    assert xu == pytest.approx(100 * least / 20e-6)
    k1b = spec.metric_module("k1b_roofline").read(run)
    assert k1b == pytest.approx(100 * (rl.soft_threshold_tail(20) * 4).seconds / 5e-6)
    step = spec.metric_module("step_roofline").read(run)
    assert step == pytest.approx(100 * (rl.lasso_step(10, 20) * 4).seconds / 37e-6)
    assert spec.metric_module("k4_roofline").read(run) is None  # lasso has no K4 layer


def test_breakdown(summary):
    ops = trace.top_device_ops(summary)
    assert [n for n, _ in ops][:2] == ["gemm_setup_kernel", "void gemv2T_kernel_val<float>"]
    assert ops[0][1] == pytest.approx(50e-6)
    gaps = dict(trace.idle_gaps(summary))
    assert gaps["aten::to"] == pytest.approx(592e-6)
    assert sum(gaps.values()) == pytest.approx(910e-6)


def test_union_seconds():
    S = trace.Span
    assert trace.union_seconds([S("a", 0, 2), S("b", 1, 3), S("c", 5, 6)]) == 4
    assert trace.union_seconds([S("a", 0, 2), S("b", 1, 3)], 1.5, 2.5) == 1.0
