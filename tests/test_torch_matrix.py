"""The port's matrix benchmark (admm_tpu_torch/benchmarks/matrix.py and
sweep.py): the card's bound and the L2 note of ``_row`` against bytes
worked by hand, the row names and widths against admm_tpu's rows (parsed
from admm_tpu/benchmarks/matrix.py), the sharded rows among them on a
stacked mesh, admm_tpu's f32 bars unchanged, the default outputs, and a
timing row, a sharded row and accuracy rows run on the CPU."""

import ast
import inspect
import re
from types import SimpleNamespace

import pytest
import torch

import admm_tpu.benchmarks.matrix as J
from admm_tpu_torch.benchmarks import matrix as M
from admm_tpu_torch.benchmarks import sweep as S

torch.set_num_threads(1)

H100_L2 = 50 * 2**20  # torch.cuda.get_device_properties(0).L2_cache_size on an H100 SXM

# admm_tpu's timing rows at full size, in its order (the sharded rows run
# their shards stacked on one device, as admm_tpu's matrix runs them).
ROWS = [
    ("model", "2048x2048"), ("lasso_fat_f32_unroll1", "1500x5000"),
    ("lasso_fat_f32", "1500x5000"), ("lasso_fat_f32_fusedkernel", "1500x5000"),
    ("lasso_fat_bf16streams", "1500x5000"), ("lasso_fat_bf16_fusedkernel", "1500x5000"),
    ("lasso_skinny_f32", "4096x1024"), ("basispursuit_f32", "512x2048"),
    ("totalvariation_dense", "n=2048"), ("totalvariation_dense", "n=8192"),
    ("totalvariation_cr", "n=8192"), ("totalvariation_cr", "n=65536"),
    ("lad_f32", "4096x512"), ("huberfit_f32", "4096x512"), ("linearprogram_f32", "n=1024"),
    ("linearprogram_chol_f32", "n=1024"), ("quadraticprogram_standard_f32", "n=1024"),
    ("quadraticprogram_bounded_f32", "n=2048"), ("covarianceselection_f32", "n=256"),
    ("covarianceselection_ns_f32", "n=256"), ("covarianceselection_ns_f32", "n=512"),
    ("covarianceselection_nsfast_f32", "n=512"), ("covarianceselection_ns_f32", "n=1024"),
    ("covarianceselection_nsfast_f32", "n=1024"), ("quantile_f32", "4096x512"),
    ("rpca_f32", "256x256"), ("rpca_rsvd16_f32", "256x256"), ("logreg_f32", "4096x256"),
    ("logreg_batch_B8_cg", "4096x256"), ("logreg_batch_B8_dense", "4096x256"),
    ("linearsvm_serial_f32", "4096x512"), ("linearsvm_sharded8_f32", "4096x512"),
    ("svm_batch_B10_onevsall", "4096x512"), ("svm_batch_sharded_B10x8shard", "4096x512"),
    ("consensus_lasso_1shard_f32", "4096x512"), ("consensus_lasso_2shard_f32", "4096x512"),
    ("consensus_lasso_4shard_f32", "4096x512"), ("consensus_lasso_8shard_f32", "4096x512"),
    ("consensus_lasso_batch_B8x8shard", "4096x512"), ("consensus_lasso_8shard_fast_f32", "4096x512"),
    ("lasso_path_B128_highest", "1500x5000"), ("lasso_path_B128_bf16pass", "1500x5000"),
    ("lasso_batch_B128", "1500x5000"), ("tv_batch_B128_cr", "n=8192"),
    ("basispursuit_batch_B128", "512x2048"), ("qp_batch_B64_standard", "n=1024"),
    ("covsel_batch_B32_ns", "n=128"), ("covsel_batch_B32_nsfast", "n=128"),
    ("sdp_batch_B16_eigh", "n=128"), ("sdp_batch_B16_ns", "n=128"),
    ("sdp_batch_B4_eigh", "n=256"), ("sdp_batch_B4_ns", "n=256"),
    ("sdp_serial_eigh", "n=512"), ("sdp_serial_ns", "n=512"),
    ("sdp_dense_serial", "n=128 m=512"), ("sdp_dense_sharded8", "n=128 m=512"),
    ("consensus_covsel_8shard_eigh", "p=256"), ("consensus_covsel_8shard_ns", "p=256"),
    ("exchange_W8", "512x256"),
]
SHARDED = re.compile(r"sharded|consensus|exchange")


def _admm_tpu_row_patterns():
    """The first argument of every ``_row(...)`` call in admm_tpu's
    ``timing_matrix``, as a regex (an f-string's fields match anything)."""
    tree = ast.parse(inspect.getsource(J))
    fn = next(n for n in tree.body if isinstance(n, ast.FunctionDef)
              and n.name == "timing_matrix")
    pats = []
    for node in ast.walk(fn):
        if (isinstance(node, ast.Call) and isinstance(node.func, ast.Name)
                and node.func.id == "_row"):
            arg = node.args[0]
            if isinstance(arg, ast.Constant):
                pats.append(re.escape(arg.value))
            else:
                pats.append("".join(re.escape(v.value) if isinstance(v, ast.Constant) else ".+"
                                    for v in arg.values))
    return [re.compile(p + "$") for p in pats]


def test_rows_are_admm_tpus_single_device_rows():
    rows = M.timing_rows(smoke=False, device="cpu")
    assert [(r.name, r.shape) for r in rows] == ROWS
    pats = _admm_tpu_row_patterns()
    for r in rows:  # every row is one of admm_tpu's, and the reverse
        assert any(p.match(r.name) for p in pats), r.name
    for p in pats:
        assert any(p.match(r.name) for r in rows), p.pattern
    assert sum(bool(SHARDED.search(r.name)) for r in rows) == 12
    for r in rows:
        assert r.iters > 0 and r.nbytes > 0 and callable(r.solve), r.name


def test_row_bound_and_l2_note_hand_worked():
    m, n, iters = 1500, 5000, 2000
    res = SimpleNamespace(steps=iters, xopt=torch.zeros(n), runtime=0.05)  # 25 us a step
    f32 = M._row("lasso_fat_f32", f"{m}x{n}", iters, res, nbytes=2 * m * n * 4,
                 flops=4 * m * n, l2_bytes=H100_L2, on_card=True)
    # Two 30 MB streams: 60 MB over 3.35 TB/s = 17.910 us; more than L2.
    assert f32["bytes_per_iter"] == 60_000_000
    assert f32["bound_ms_per_iter"] == pytest.approx(60e6 / 3.35e12 * 1e3)
    assert f32["bound_ms_per_iter"] == pytest.approx(0.0179104, rel=1e-5)
    assert f32["bound_by"] == "bytes" and "roofline_note" not in f32
    assert f32["pct_of_roofline"] == pytest.approx(100 * 0.0179104 / 0.025, rel=1e-5)
    bf16 = M._row("lasso_fat_bf16streams", f"{m}x{n}", iters, res, nbytes=2 * m * n * 2,
                  flops=4 * m * n, l2_bytes=H100_L2, on_card=True)
    # Two 15 MB streams fit in the 50 MB L2: no percentage.
    assert bf16["bound_ms_per_iter"] == pytest.approx(30e6 / 3.35e12 * 1e3)
    assert bf16["roofline_note"] == "l2-resident; % n/a" and "pct_of_roofline" not in bf16
    # A compute-bound row: the operations bound it.
    ms, by = M.bound_ms(1e6, 67e9)
    assert by == "operations" and ms == pytest.approx(1.0)
    # Off the card: the bound, no percentage.
    cpu = M._row("lasso_fat_f32", "", iters, res, nbytes=60e6, flops=0)
    assert "pct_of_roofline" not in cpu and "roofline_note" not in cpu
    short = M._row("x", "", iters, SimpleNamespace(steps=7, xopt=torch.zeros(2), runtime=1.0))
    assert short["valid"] is False and short["steps_ran"] == 7


def test_f32_bars_and_sweep_plan_are_admm_tpus():
    from admm_tpu.benchmarks import sweep as JS

    assert M._F32_ERRTOL == J._F32_ERRTOL
    assert S._PLAN == JS._PLAN
    assert S._F32_ERRTOL is M._F32_ERRTOL


def test_default_outputs_are_not_admm_tpus_files():
    out = inspect.signature(M.main).parameters["out_path"].default
    assert out == "BENCH_MATRIX_TORCH.json" != "BENCH_MATRIX.json"
    out = inspect.signature(S.main).parameters["out_path"].default
    assert out == "BENCH_SWEEP_TORCH.json" != "BENCH_SWEEP.json"
    assert inspect.signature(M.main).parameters["device"].default == "cuda"


def test_bare_loop_floor_runs():
    # The eager loop of a GEMV chain with the engine's tail (on the card
    # only in the matrix; here at a toy size, for its arithmetic).
    assert M._bare_loop_ips(((8, 4), (4, 8)), 5, torch.device("cpu")) > 0


def test_one_smoke_row_on_the_cpu(capsys):
    (row,) = M.timing_matrix(smoke=True, device="cpu", steps=20, only={"model"})
    assert row["solver"] == "model" and row["shape"] == "512x512" and row["iters"] == 20
    assert row["matrix_iters"] == 800 and "valid" not in row and row["device"] == "cpu"
    assert row["bound_ms_per_iter"] == pytest.approx(2 * 512 * 512 * 4 / 3.35e12 * 1e3)
    assert "pct_of_roofline" not in row and "bare_loop_iter_s" not in row
    assert '"solver": "model"' in capsys.readouterr().out
    (sharded,) = M.timing_matrix(smoke=True, device="cpu", steps=5, only={"exchange_W8"})
    assert sharded["solver"] == "exchange_W8" and sharded["shape"] == "128x64"
    assert sharded["iters"] == 5 and "valid" not in sharded and "skipped" not in sharded


def test_one_accuracy_row_on_the_cpu():
    rows = M.accuracy_matrix(device="cpu", only={"lasso", "elasticnet_ridge",
                                                 "exchange_equilibrium"})
    assert [r["solver"] for r in rows] == ["lasso", "elasticnet_ridge", "exchange_equilibrium"]
    assert all(not r["failed"] for r in rows)
    assert rows[0]["f32_errtol"] == 1e-3 and rows[1]["relerror"] <= 1e-3
    assert rows[2]["f32_errtol"] == 1e-3
