"""Nothing the benchmark runs imports ``jax`` or ``admm_tpu`` (top-level
names compared whole: ``admm_tpu_torch`` begins with ``admm_tpu``), and
the references import nothing of the port."""

import ast
import subprocess
import sys
from pathlib import Path

BENCH = Path(__file__).resolve().parents[1]
FORBIDDEN = {"jax", "jaxlib", "flax", "admm_tpu"}


def _imports(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def _sources():
    return [p for p in BENCH.rglob("*.py") if "tests" not in p.relative_to(BENCH).parts]


def test_sources_import_no_jax_and_references_none_of_the_port():
    for p in _sources():
        tops = {m.split(".")[0] for m in _imports(p)}
        assert not tops & FORBIDDEN, (p, tops & FORBIDDEN)
        if p.parent.name == "reference":
            assert "admm_tpu_torch" not in tops, p


def _loaded(code):
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=300, cwd=str(BENCH.parent))
    assert out.returncode == 0, out.stderr
    return set(out.stdout.split())


PRELUDE = ("import sys; sys.path[:0] = [{b!r}, {r!r}]; ".format(b=str(BENCH), r=str(BENCH.parent)))


RUN_ALL = """
from benchlib import spec, runner, trace, window, compare, context, device, roofline
import calibrate, pathlib, torch
sys.path.insert(0, {tests!r})
from conftest import make_copy
root = make_copy(pathlib.Path({tmp!r}))
for name in ['lasso_boyd_1500x5000.solve', 'tv1d_65536.solve', 'lasso_boyd_1500x5000.path100']:
    c = spec.cell(name, root)
    c.family.controls(c.config, c.traffic)
    r = runner.run_cell(c, 3, 0.2, name.endswith('solve'), torch.device('cpu'), 0.0,
                        log=lambda s: None)
    assert r['correct'], r
print(' '.join(sorted({{m.split('.')[0] for m in sys.modules}})))
"""


def test_every_module_the_benchmark_runs_loads_no_jax(tmp_path):
    tops = _loaded(PRELUDE + "\n" + RUN_ALL.format(tests=str(BENCH / "tests"), tmp=str(tmp_path)))
    assert "admm_tpu_torch" in tops
    assert not tops & FORBIDDEN, tops & FORBIDDEN


def test_references_load_nothing_of_the_port():
    code = PRELUDE + ("import reference.lasso, reference.tv1d, reference.common\n"
                      "print(' '.join(sorted({m.split('.')[0] for m in sys.modules})))\n")
    tops = _loaded(code)
    assert not tops & (FORBIDDEN | {"admm_tpu_torch", "benchlib", "families"}), tops
