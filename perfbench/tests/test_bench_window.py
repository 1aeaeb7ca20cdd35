"""The window's rate and tail arithmetic over all its requests."""

import time

import pytest

from benchlib import window


def _fake(durations):
    """An issue function whose request i sleeps durations[i]."""

    def issue(i, traced):
        t0 = time.perf_counter()
        time.sleep(durations[min(i, len(durations) - 1)])
        return window.Request(i, t0, time.perf_counter(), 2, [10, 30], 30, 0.0, False, traced)

    return issue


def test_nearest_rank():
    vals = list(range(1, 101))
    assert window.nearest_rank(vals, 0.95) == 95
    assert window.nearest_rank(vals, 0.5) == 50
    assert window.nearest_rank([7.0], 0.95) == 7.0
    assert window.nearest_rank(list(range(1, 21)), 0.95) == 19


def test_rates_are_over_all_work_and_all_time():
    w = window.Window([window.Request(i, float(i), i + 0.5, 2, [3, 5], 5, 0.1, False)
                       for i in range(10)], 0.0, 9.5)
    e = window.end_to_end(w)
    assert e["solves_per_s"] == pytest.approx(20 / 9.5)
    assert e["iter_per_s"] == pytest.approx(80 / 9.5)
    assert e["solve_ms_p95"] == pytest.approx(500.0)


def test_a_stall_moves_rate_and_tail():
    steady = window.end_to_end(window.run(_fake([0.01]), 0.4))
    stalled = window.end_to_end(window.run(_fake([0.01] * 5 + [0.25] + [0.01]), 0.4))
    assert stalled["solves_per_s"] < 0.8 * steady["solves_per_s"]
    assert stalled["iter_per_s"] < 0.8 * steady["iter_per_s"]
    assert stalled["solve_ms_p95"] > 200.0 > steady["solve_ms_p95"]


def test_window_runs_past_its_end_to_the_last_return_and_traces_whole_requests():
    calls = []
    w = window.run(_fake([0.05]), 0.12, trace_at=0.5, trace_seconds=0.06,
                   start_trace=lambda: calls.append("start"), stop_trace=lambda: calls.append("stop"))
    assert calls == ["start", "stop"]
    assert w.seconds >= 0.12
    assert w.t1 == w.requests[-1].t1 and w.t0 == w.requests[0].t0
    traced = [r.traced for r in w.requests]
    assert any(traced) and traced.index(True) >= 1
