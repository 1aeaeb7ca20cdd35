"""Cells, configurations, traffic mixes, limits and metrics are found by
name, and a new one of each is found without editing an existing file."""

import json
import shutil

import pytest

from benchlib import spec

CELLS = ["lasso_boyd_1500x5000.solve", "tv1d_65536.solve", "lasso_boyd_1500x5000.path100"]


@pytest.mark.parametrize("name", CELLS)
def test_cell_resolves_every_file(name):
    c = spec.cell(name)
    assert c.chips == 1
    assert c.config["name"] == c.config_name
    assert c.traffic["kind"] in ("solve", "path")
    assert {"iterate_gap", "stop_lag"} <= set(c.limits)
    for key in ("make_pool", "requests", "port", "controls", "reference", "layer_cost"):
        assert callable(getattr(c.family, key))
    assert {m.name for m in c.end_to_end} >= {"setup_s", "solves_per_s", "iter_per_s"}
    assert c.per_layer and all(callable(m.module.read) for m in c.per_layer)


def test_benchmark_json_agrees_with_metric_files():
    bench = spec.load_benchmark()
    for m in bench["per_layer"]:
        mod = spec.metric_module(m["name"])
        assert (m["unit"], m["better"], m["source"], m["layer"], m["moves"]) == (
            mod.UNIT, mod.BETTER, mod.SOURCE, mod.LAYER, mod.MOVES)
        assert m["workloads"] == mod.WORKLOADS
        moved = next(e for e in bench["end_to_end"] if e["name"] == m["moves"])
        for w in m["workloads"]:
            assert "workloads" not in moved or w in moved["workloads"]


def test_p95_only_in_the_solve_cells():
    assert "solve_ms_p95" in {m.name for m in spec.cell(CELLS[0]).end_to_end}
    assert "solve_ms_p95" in {m.name for m in spec.cell(CELLS[1]).end_to_end}
    assert "solve_ms_p95" not in {m.name for m in spec.cell(CELLS[2]).end_to_end}


def test_new_config_traffic_metric_and_cell_need_no_edit(tmp_path):
    from conftest import make_copy

    root = make_copy(tmp_path, small=False)
    before = {p: p.read_bytes() for p in (root / "perfbench").rglob("*") if p.is_file()}
    pb = root / "perfbench"
    cfg = json.loads((pb / "configs" / "tv1d_65536.json").read_text())
    cfg.update(name="tv1d_4096", n=4096)
    (pb / "configs" / "tv1d_4096.json").write_text(json.dumps(cfg))
    trf = json.loads((pb / "traffic" / "solve.json").read_text())
    trf.update(pool=8)
    (pb / "traffic" / "solve_small.json").write_text(json.dumps(trf))
    (pb / "metrics" / "requests_traced.py").write_text(
        'UNIT = "requests"\nBETTER = "higher"\nSOURCE = "program_counter"\n'
        'LAYER = "solver"\nMOVES = "solves_per_s"\nWORKLOADS = ["tv1d_4096.solve_small"]\n\n'
        'def read(run):\n    return float(len(run.traced))\n')
    shutil.copy(pb / "limits" / "tv1d_65536.solve.json", pb / "limits" / "tv1d_4096.solve_small.json")
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": "tv1d_4096", "source": "test", "file":
                             "perfbench/configs/tv1d_4096.json", "reduced": ["n"], "why": "test"})
    bench["workloads"].append({"name": "tv1d_4096.solve_small", "config": "tv1d_4096",
                               "traffic": "solve_small", "chips": 1, "why": "test"})
    bench["per_layer"].append({"name": "requests_traced", "unit": "requests", "better": "higher",
                               "source": "program_counter", "layer": "solver",
                               "moves": "solves_per_s", "workloads": ["tv1d_4096.solve_small"]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    c = spec.cell("tv1d_4096.solve_small", root)
    assert c.config["n"] == 4096 and c.traffic["pool"] == 8
    assert "requests_traced" in {m.name for m in c.per_layer}
    assert c.limits["stop_lag"]["limit"] >= 0
    after = {p: p.read_bytes() for p in before}
    assert after == before
