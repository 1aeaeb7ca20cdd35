"""Fixtures of the benchmark's CPU tests: the harness on the path, and a
small copy of the benchmark in a temporary directory."""

import json
import shutil
import sys
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent
for p in (str(ROOT), str(BENCH)):
    if p not in sys.path:
        sys.path.insert(0, p)

# Sizes a CPU test can hold, with every width kept in proportion.
SMALL = {"lasso_boyd_1500x5000": {"m": 60, "n": 200},
         "tv1d_65536": {"n": 4096}}


def make_copy(dest: Path, small: bool = True) -> Path:
    """A copy of BENCHMARK.json and perfbench/ under ``dest``, with the
    configurations cut to CPU sizes and pools of 4 where ``small``."""
    shutil.copytree(BENCH, dest / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    shutil.copy(ROOT / "BENCHMARK.json", dest / "BENCHMARK.json")
    if small:
        for name, sizes in SMALL.items():
            p = dest / "perfbench" / "configs" / f"{name}.json"
            cfg = json.loads(p.read_text())
            cfg.update(sizes)
            p.write_text(json.dumps(cfg))
        for p in (dest / "perfbench" / "traffic").glob("*.json"):
            t = json.loads(p.read_text())
            t["pool"] = 4
            p.write_text(json.dumps(t))
    return dest


@pytest.fixture
def small_root(tmp_path):
    return make_copy(tmp_path)


@pytest.fixture
def cuda():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")
