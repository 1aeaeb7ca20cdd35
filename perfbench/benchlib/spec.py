"""Find a cell of ``BENCHMARK.json`` and every file it names, by name.

A cell names a configuration and a traffic mix.  The configuration's
file (``configs[].file``) names its problem family, whose module is
``perfbench/families/<family>.py``; the traffic mix is
``perfbench/traffic/<traffic>.json``; the limits of the cell's
comparison are ``perfbench/limits/<cell>.json``; each per-layer metric
is ``perfbench/metrics/<metric>.py``.  Adding any of them is adding a
file and an entry of ``BENCHMARK.json``: no existing file changes.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
BENCH_DIR = "perfbench"


@dataclasses.dataclass
class Metric:
    """A metric of ``BENCHMARK.json``; ``module`` is the reader of a
    per-layer metric (None for an end-to-end one)."""

    name: str
    unit: str
    better: str
    source: str
    entry: dict
    module: object = None


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config_name: str
    config: dict
    traffic_name: str
    traffic: dict
    family: object
    limits: dict
    end_to_end: list
    per_layer: list
    root: Path


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_benchmark(root: Path = ROOT) -> dict:
    return load_json(root / "BENCHMARK.json")


def load_module(path: Path, name: str):
    """Import the file ``path`` as a module called ``name`` (cached in
    ``sys.modules`` under that name)."""
    if name in sys.modules and getattr(sys.modules[name], "__file__", None) == str(path):
        return sys.modules[name]
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None:
        raise FileNotFoundError(path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod
    spec.loader.exec_module(mod)
    return mod


def family_module(family: str, root: Path = ROOT):
    return load_module(root / BENCH_DIR / "families" / f"{family}.py",
                       f"perfbench_family_{family}")


def metric_module(name: str, root: Path = ROOT):
    return load_module(root / BENCH_DIR / "metrics" / f"{name}.py",
                       f"perfbench_metric_{name}")


def _reports(entry: dict, cell: str) -> bool:
    return "workloads" not in entry or cell in entry["workloads"]


def cell(name: str, root: Path = ROOT) -> Cell:
    """The cell ``name`` with its configuration, traffic mix, family
    module, limits and metrics resolved from their files."""
    bench = load_benchmark(root)
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json; have {sorted(cells)}")
    w = cells[name]
    configs = {c["name"]: c for c in bench["configs"]}
    config = load_json(root / configs[w["config"]]["file"])
    traffic = load_json(root / BENCH_DIR / "traffic" / f"{w['traffic']}.json")
    limits_path = root / BENCH_DIR / "limits" / f"{name}.json"
    limits = load_json(limits_path) if limits_path.exists() else {}
    e2e = [Metric(m["name"], m["unit"], m["better"], m["source"], m)
           for m in bench["end_to_end"] if _reports(m, name)]
    moved = {m.name for m in e2e}
    per_layer = []
    for m in bench["per_layer"]:
        if "workloads" in m and name not in m["workloads"]:
            continue
        if "workloads" not in m and m["moves"] not in moved:
            continue
        per_layer.append(Metric(m["name"], m["unit"], m["better"], m["source"], m,
                                metric_module(m["name"], root)))
    return Cell(name=name, chips=int(w["chips"]), config_name=w["config"], config=config,
                traffic_name=w["traffic"], traffic=traffic,
                family=family_module(config["family"], root), limits=limits,
                end_to_end=e2e, per_layer=per_layer, root=root)
