"""``replayed_chunk_pct`` on a small canned trace
(``data/canned_trace_replay.json``): one request whose three chunks each
hold a replay (the first also its capture), one eager request of two
chunks, every value below counted by hand from the file; and nothing on
traces without chunk spans."""

from pathlib import Path

import pytest

from benchlib import spans, spec, trace
from benchlib.context import RunData
from benchlib.window import Request
from families import lasso

DATA = Path(__file__).resolve().parent / "data"


def _run(name, failed=(False, False)):
    summary = trace.load(str(DATA / name))
    reqs = [Request(i, float(i), float(i) + 1.0, 1, [4], 4, 0.0, f, traced=True)
            for i, f in enumerate(failed)]
    return RunData({"m": 10, "n": 20}, {}, lasso, reqs, reqs, summary)


def _read(run):
    return spec.metric_module("replayed_chunk_pct").read(run)


def test_chunks_and_replays_paired_with_their_requests():
    run = _run("canned_trace_replay.json")
    (a, replayed), (b, eager) = spans.by_request(run)
    assert (a, b) == tuple(run.traced)
    names = ("chunk", "capture", "replay", "step")
    assert [len(replayed.get(k, [])) for k in names] == [3, 1, 3, 2]
    assert [len(eager.get(k, [])) for k in names] == [2, 0, 0, 4]


@pytest.mark.parametrize("failed,value", [
    ((False, False), 100 * 3 / 5),   # three replayed chunks of five
    ((True, False), 0.0),            # the eager request alone
    ((False, True), 100.0),          # the replayed request alone
])
def test_replayed_chunk_pct(failed, value):
    run = _run("canned_trace_replay.json", failed)
    assert _read(run) == pytest.approx(value)
    if not all(failed):
        assert any(n.startswith("replayed_chunk_pct: ") for n in run.notes)


def test_graph_launches_count_once():
    # Request A: two launches during the capture and three cudaGraphLaunch
    # calls, whose six kernels carry the graph launches' ids; request B:
    # four launches.  No kernel counts as a launch the trace missed.
    run = _run("canned_trace_replay.json")
    assert all(e is not None for e in run.trace.engine)
    assert run.trace.launch_count() == 5 + 4


def test_no_chunk_spans_read_none():
    assert _read(_run("canned_trace_replay.json", (True, True))) is None
    # Traces of a program that records no chunk spans.
    assert _read(_run("canned_trace_spans.json", (False,))) is None
    assert _read(_run("canned_trace.json", (False,))) is None
