"""The least-time arithmetic against hand counts."""

import pytest

from benchlib import roofline as rl
from benchlib.context import RunData
from families import lasso, tv1d


def test_xupdate_hand_count():
    c = rl.fat_lasso_xupdate(1500, 5000)
    # D once, a triangular 1500 x 1500 factor once; q in, x out
    assert c.bytes == 4 * (1500 * 5000 + 1500 * 1501 // 2 + 2 * 5000)
    assert c.flops == 4 * 1500 * 5000                         # two products, 2 m n each
    assert c.bound == "bytes"
    assert c.seconds == pytest.approx(34.543e6 / 3.35e12)     # 10.31 us


def test_xupdate_over_100_lanes_is_operations_bound():
    c = rl.fat_lasso_xupdate(1500, 5000, lanes=100)
    assert c.flops == 100 * 4 * 1500 * 5000
    assert c.bound == "operations"
    assert c.seconds == pytest.approx(3.0e9 / 67e12)


def test_tail_tridiagonal_and_steps():
    assert rl.soft_threshold_tail(5000).bytes == 4 * 5 * 5000
    assert rl.tridiagonal_solve(65536).bytes == 4 * 5 * 65536
    assert rl.tridiagonal_solve(65536, lanes=16).bytes == 4 * (3 + 32) * 65536
    assert rl.lasso_step(1500, 5000).bytes == 4 * (1500 * 5000 + 1500 * 1501 // 2 + 6 * 5000)
    assert rl.tv_step(65536).bytes == 4 * 9 * 65536
    assert (rl.Cost(1.0, 2.0) + rl.Cost(3.0, 4.0)) * 2 == rl.Cost(8.0, 12.0)
    assert rl.share(1.0, 0.0) is None and rl.share(1.0, 4.0) == 25.0


def test_least_counts_the_steps_each_lane_needed():
    cfg = {"m": 10, "n": 20}

    class R:
        def __init__(self, steps):
            self.steps = steps

    run = RunData(cfg, {}, lasso, [], [R([3, 1, 2])])
    got = run.least("xupdate")
    # sub-step 1: 3 lanes, 2: 2 lanes, 3: 1 lane
    want = (rl.fat_lasso_xupdate(10, 20, 3) + rl.fat_lasso_xupdate(10, 20, 2)
            + rl.fat_lasso_xupdate(10, 20, 1))
    assert got == want
    assert run.steps_covered() == 3
    assert RunData({"n": 8}, {}, tv1d, [], [R([5])]).least("xupdate") is None
