"""The port's spans (``admm_tpu_torch.utils.profiling.span``) in a
``torch.profiler`` trace of whole solves on the CPU: one loop span a
solve, after its set-up and its one preparation span and before its one
result span; one step span a sub-step issued (chunks x K, once for all
lanes), each holding one x-update and one tail span; results bit for bit
those of a solve with no profiler running; and nothing recorded without
one."""

import json
import math

import numpy as np
import pytest
import torch

from admm_tpu_torch import ADMMConfig, engine, lasso, lasso_path, totalvariation
from admm_tpu_torch.utils import profiling

torch.set_num_threads(1)

PREFIX = "admm_tpu_torch."


def _fat_lasso():
    rng = np.random.default_rng(3)
    D = rng.standard_normal((30, 80))
    D /= np.linalg.norm(D, axis=0)
    s = D @ (rng.standard_normal(80) * (rng.random(80) < 0.1)) + 0.03 * rng.standard_normal(30)
    return D, s, 0.1 * float(np.max(np.abs(D.T @ s)))


def _signal():
    rng = np.random.default_rng(4)
    return np.repeat(rng.integers(1, 10, 8).astype(float), 512) + rng.standard_normal(4096)


def _solve(case):
    """(result, K) of one small solve of ``case``."""
    if case == "lasso_fused":
        D, s, lam = _fat_lasso()
        return lasso(D, s, lam, ADMMConfig(maxiters=300, unroll=8), use_fused_kernel=True,
                     device="cpu"), 8
    if case == "lasso_generic":
        D, s, lam = _fat_lasso()
        return lasso(D, s, lam, ADMMConfig(maxiters=300, unroll=3), device="cpu"), 3
    if case == "tv":
        return totalvariation(_signal(), 5.0, ADMMConfig(maxiters=40, unroll=4),
                              device="cpu"), 4
    D, s, lam = _fat_lasso()
    lams = lam * np.array([4.0, 1.0, 0.25])
    return lasso_path(D, s, lams, ADMMConfig(maxiters=300, unroll=2), device="cpu"), 2


def _steps(res):
    return res.steps.tolist() if isinstance(res.steps, torch.Tensor) else [res.steps]


def _traced(case, tmp_path, monkeypatch):
    """Solve ``case`` under ``profiling.trace``; return the result, K, the
    chunk count (the host reads of the stop flags) and the program spans
    as {name: [(t0, t1), ...]} in trace order."""
    reads = [0]
    run_chunks = engine._run_chunks

    def counted(step, flags, N, K, table=None, lane_k=None, graph=None):
        def read():
            reads[0] += 1
            return flags()

        return run_chunks(step, read, N, K, table, lane_k, graph)

    monkeypatch.setattr(engine, "_run_chunks", counted)
    with profiling.trace(str(tmp_path)):
        res, K = _solve(case)
    with open(tmp_path / "trace.json") as f:
        events = json.load(f)["traceEvents"]
    spans = {}
    for e in sorted((e for e in events if e.get("ph") == "X"
                     and e.get("name", "").startswith(PREFIX)), key=lambda e: float(e["ts"])):
        t0 = float(e["ts"])
        spans.setdefault(e["name"][len(PREFIX):], []).append((t0, t0 + float(e["dur"])))
    return res, K, reads[0], spans


CASES = ["lasso_fused", "lasso_generic", "tv", "path"]


@pytest.mark.parametrize("case", CASES)
def test_spans_count_and_order(case, tmp_path, monkeypatch):
    res, K, chunks, spans = _traced(case, tmp_path, monkeypatch)
    assert set(spans) == {"setup", "prepare", "loop", "chunk", "step", "step.xupdate",
                          "step.tail", "result"}
    (loop,) = spans["loop"]
    assert len(spans["prepare"]) == len(spans["result"]) == 1
    assert all(t1 <= loop[0] for _, t1 in spans["setup"] + spans["prepare"])
    assert all(t0 >= loop[1] for t0, _ in spans["result"])
    # One step span a sub-step issued: chunks of K until the longest
    # instance's stop (lanes frozen behind it run on).
    assert chunks == math.ceil(max(_steps(res)) / K) == len(spans["chunk"])
    assert len(spans["step"]) == chunks * K
    assert all(loop[0] <= t0 and t1 <= loop[1] for t0, t1 in spans["chunk"])
    for i, (t0, t1) in enumerate(spans["chunk"]):
        assert all(t0 <= s0 and s1 <= t1 for s0, s1 in spans["step"][i * K:(i + 1) * K])
    assert all(loop[0] <= t0 and t1 <= loop[1] for t0, t1 in spans["step"])
    for phase in ("step.xupdate", "step.tail"):
        assert len(spans[phase]) == len(spans["step"])
        for (t0, t1), (s0, s1) in zip(spans[phase], spans["step"]):
            assert s0 <= t0 and t1 <= s1
    for (x0, x1), (t0, t1) in zip(spans["step.xupdate"], spans["step.tail"]):
        assert x1 <= t0


@pytest.mark.parametrize("case", CASES)
def test_results_bit_identical_with_and_without_a_profiler(case, tmp_path, monkeypatch):
    traced, _, _, _ = _traced(case, tmp_path, monkeypatch)
    plain, _ = _solve(case)
    assert _steps(traced) == _steps(plain)
    for a, b in [(getattr(traced, k), getattr(plain, k)) for k in ("xopt", "zopt", "uopt")] + [
            (traced.hist[k], plain.hist[k]) for k in ("pnorm", "dnorm")]:
        torch.testing.assert_close(a, b, rtol=0, atol=0, equal_nan=True)


def _names(tmp_path, body):
    with profiling.trace(str(tmp_path)):
        body()
    with open(tmp_path / "trace.json") as f:
        return [e.get("name") for e in json.load(f)["traceEvents"] if e.get("ph") == "X"]


def test_span_records_nothing_without_a_profiler(tmp_path):
    # A span opened while no profiler runs records nothing, even when a
    # profiler starts inside it; one opened under the profiler does.
    with profiling.span("admm_tpu_torch.loop"):
        names = _names(tmp_path, lambda: torch.ones(3) + 1)
    assert not any(n.startswith(PREFIX) for n in names)

    def inner():
        with profiling.span("admm_tpu_torch.step"):
            torch.ones(3) + 1

    assert _names(tmp_path, inner).count("admm_tpu_torch.step") == 1

