"""The port's weak-scaling harness and collective cost model
(``admm_tpu_torch/benchmarks/scaling.py``): the twins of
tests/test_profiling_scaling.py's two scaling tests with their checks,
the cost model's tiers (public specifications of NVLink 4 and a host
NIC, not admm_tpu's), and the microbench over two gloo ranks."""

import numpy as np
import torch

from admm_tpu_torch.benchmarks import scaling
from admm_tpu_torch.benchmarks.scaling import (breakeven_table, collective_microbench,
                                               predict_weak_scaling, weak_scaling)

from _torch_ranks import check, run_ranks

torch.set_num_threads(1)


def test_weak_scaling_harness_runs():
    results, effs = weak_scaling(device_counts=(1, 2), rows_per_shard=64, cols=16, iters=20,
                                 quiet=True, device="cpu")
    assert set(results) == {1, 2}
    assert all(v > 0 for v in results.values())
    assert effs[1] == 1.0


def test_collective_microbench_and_cost_model():
    rows = collective_microbench(payload_floats=(64,), inner=8, quiet=True, device="cpu")
    assert rows and rows[0]["us_per_collective"] > 0 and rows[0]["backend"] == "stacked"
    lo = predict_weak_scaling(20.0, 512, quiet=True)
    hi = predict_weak_scaling(2000.0, 512, quiet=True)
    by = {(r["tier"], r["devices"]): r for r in lo}
    by_hi = {(r["tier"], r["devices"]): r for r in hi}
    for k in by:
        assert by_hi[k]["efficiency"] > by[k]["efficiency"]
    # Big-body consensus meets the target over NVLink.
    assert by_hi[("nvlink4", 8)]["meets_target"]
    # The host NIC is strictly worse than NVLink at the same compute.
    assert by[("nic_ndr400", 2)]["efficiency"] < by[("nvlink4", 8)]["efficiency"]
    be = breakeven_table(512, lanes=(1, 8), quiet=True)
    per = {(r["tier"], r["lanes"]): r for r in be}
    # Lanes amortize the latency: the per-lane compute needed for 80% falls.
    assert (per[("nvlink4", 8)]["min_per_lane_compute_us_for_80pct"]
            < per[("nvlink4", 1)]["min_per_lane_compute_us_for_80pct"])


def test_cost_model_payloads_are_the_counted_ones():
    # The model's rounds are the collectives a consensus step issues, as
    # Mesh.stats counts them (tests/test_torch_collectives.py): 2n + 1.
    assert scaling.consensus_payloads(512) == (1024, 1)
    row = predict_weak_scaling(100.0, 512, scenarios=(("nvlink4", 2),), quiet=True)[0]
    assert row["payload_floats_per_step"] == [1024, 1]
    want = sum(2.0 * 0.5 * 4.0 * p / 450e3 + 2.0 * 1.0 for p in (1024, 1))
    np.testing.assert_allclose(row["t_collective_us"], want, rtol=1e-12)
    for tier in scaling._TIERS.values():
        assert "assumed" in tier["source"]


def test_cost_model_charges_the_host_time_of_each_collective():
    # The measured host time of a collective is added once for each of a
    # step's collectives; the wire-only efficiency stays beside it.
    wire = predict_weak_scaling(100.0, 512, scenarios=(("nvlink4", 8),), quiet=True)[0]
    row = predict_weak_scaling(100.0, 512, scenarios=(("nvlink4", 8),), quiet=True,
                               host_us=300.0)[0]
    np.testing.assert_allclose(row["t_collective_us"], wire["t_collective_us"] + 600.0,
                               rtol=1e-12)
    assert row["t_wire_us"] == wire["t_collective_us"]
    assert row["efficiency_wire_only"] == wire["efficiency"] > row["efficiency"]
    assert not row["meets_target"]
    be = breakeven_table(512, lanes=(1,), quiet=True, host_us=300.0)[0]
    assert be["t_collective_us"] > 600.0
    us, rows = scaling.host_collective_us(16, inner=4, quiet=True, device="cpu")
    assert us > 0 and {r["backend"] for r in rows} == {"gloo"}
    assert [r["payload_floats"] for r in rows] == [32, 1] and rows[0]["ranks"] == 1
    assert not torch.distributed.is_initialized()


def test_collective_microbench_over_two_gloo_ranks(tmp_path):
    rc, init, out, res = run_ranks('''
        from admm_tpu_torch.benchmarks.scaling import collective_microbench
        rows = collective_microbench(payload_floats=(1, 1024), inner=8, quiet=True, mesh=mesh)
        save(us=np.array([r["us_per_collective"] for r in rows]),
             ranks=np.array([r["ranks"] for r in rows]))
        assert {r["backend"] for r in rows} == {"gloo"}
    ''', tmp_path)
    check(rc, init, out)
    for r in res:
        assert (r["us"] > 0).all() and r["ranks"].tolist() == [2, 2]
