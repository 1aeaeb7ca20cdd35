"""Parity of the port's fused z/u pass (admm_tpu_torch/ops/kernels.py)
against admm_tpu's Pallas kernel (interpret mode) and its jnp twin, and
the CUDA kernel's launch plan.

The CUDA C++ kernel itself (csrc/zu_tail.cu) runs only on a CUDA device;
its cases are in tests/test_torch_gpu.py.
"""

import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from admm_tpu.ops.kernels import _fused_jnp
from admm_tpu.ops.kernels import fused_soft_threshold_dual as jax_fused
from admm_tpu_torch.ops import kernels
from admm_tpu_torch.ops.kernels import (
    ZU_MAX_BLOCKS, ZU_THREADS, _fused_torch, fused_soft_threshold_dual, zu_blocks)

torch.set_num_threads(1)


def _inputs(n, seed=0):
    rng = np.random.default_rng(seed)
    return rng.standard_normal(n), rng.standard_normal(n), 0.37


@pytest.mark.parametrize("n", [64, 1000, 8192, 70000])
def test_fused_torch_matches_pallas_and_jnp(n):
    x, u, t = _inputs(n)
    z_t, u_t = _fused_torch(torch.from_numpy(x), torch.from_numpy(u), t)
    # force_pallas runs admm_tpu's kernel in interpret mode on the CPU.
    z_p, u_p = jax_fused(jnp.asarray(x), jnp.asarray(u), t, force_pallas=True)
    z_j, u_j = _fused_jnp(jnp.asarray(x), jnp.asarray(u), t)
    for z_ref, u_ref in ((z_p, u_p), (z_j, u_j)):
        np.testing.assert_allclose(z_t.numpy(), np.asarray(z_ref), rtol=0, atol=1e-12)
        np.testing.assert_allclose(u_t.numpy(), np.asarray(u_ref), rtol=0, atol=1e-12)


@pytest.mark.parametrize("t_kind", ["float", "tensor"])
def test_cpu_wrapper_takes_twin_and_counts_nothing(t_kind, monkeypatch):
    monkeypatch.setattr(fused_soft_threshold_dual, "launches", 0)
    x, u, t = _inputs(1000, seed=1)
    x, u = torch.from_numpy(x), torch.from_numpy(u)
    if t_kind == "tensor":
        t = torch.tensor(t, dtype=torch.float64)
    u_before = u.clone()
    z_w, u_w = fused_soft_threshold_dual(x, u, t)
    z_t, u_t = _fused_torch(x, u, t)
    assert torch.equal(z_w, z_t) and torch.equal(u_w, u_t)
    assert torch.equal(u, u_before)  # out of place
    assert fused_soft_threshold_dual.launches == 0


def test_wrapper_refuses_other_devices():
    x = torch.zeros(8, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        fused_soft_threshold_dual(x, x, 0.1)


@pytest.mark.parametrize("itemsize", [4, 8])
@pytest.mark.parametrize("n", [1, 3, 1024, 1025, 5000, 70000, 2**20, 2**22 + 3])
def test_launch_plan_covers_n(n, itemsize):
    W = 16 // itemsize
    blocks = zu_blocks(n, itemsize)
    assert 1 <= blocks <= ZU_MAX_BLOCKS
    per_block = ZU_THREADS * W
    if blocks < ZU_MAX_BLOCKS:
        # One 16-byte chunk per thread: as few blocks as cover n.
        assert (blocks - 1) * per_block < n <= blocks * per_block
    # The kernel's grid-stride loops, thread by thread, visit every element
    # exactly once, with and without the 16-byte chunks.
    stride = blocks * ZU_THREADS
    g = np.arange(stride)
    for vec in (True, False):
        nv = n // W if vec else 0
        seen = np.zeros(n, np.int64)
        c = g.copy()
        while (live := c < nv).any():
            for lane in range(W):
                np.add.at(seen, c[live] * W + lane, 1)
            c += stride
        i = nv * W + g
        while (live := i < n).any():
            np.add.at(seen, i[live], 1)
            i += stride
        assert np.all(seen == 1)
    # The tail mode reduces in one cluster exactly when the grid fits one.
    assert kernels.zu_tail_plan(n, itemsize) == (blocks, blocks <= kernels.ZU_CLUSTER_BLOCKS)
    scratch = kernels.zu_tail_scratch(n, torch.float64 if itemsize == 8 else torch.float32,
                                      "cpu")
    assert scratch.numel() == 16 + 8 * kernels.ZU_SUMS * blocks and not scratch.any()


def test_kernel_source_imports_without_building():
    # The kernels are built at first launch, never at import: importing
    # the modules here (no nvcc, no card) built nothing.
    from admm_tpu_torch.ops import _cuda

    assert _cuda.library.cache_info().currsize == 0
    assert "zu_tail.cu" in _cuda.SOURCES and (_cuda.CSRC / "zu_tail.cu").exists()
    assert {"admm_zu", "admm_zu_tail"} <= set(_cuda._SIGNATURES)
    # The plan's constants are the kernel's.
    src = (_cuda.CSRC / "zu_tail.cu").read_text()
    assert f"constexpr int kThreads = {ZU_THREADS};" in src
    assert f"constexpr int kSums = {kernels.ZU_SUMS};" in src
    assert f"constexpr int kEdges = {kernels.ZU_EDGES};" in src
    assert f"constexpr int kMaxCluster = {kernels.ZU_CLUSTER_BLOCKS};" in src
    assert (f"constexpr int kDomaxiters = {kernels.DOMAXITERS}, kNodualerror = "
            f"{kernels.NODUALERROR}, kNanguard = {kernels.NANGUARD}, kDiffOp = "
            f"{kernels.DIFFOP};") in src
    # One toolchain builds every kernel of the port: nothing imports Triton.
    for path in _cuda.CSRC.parent.rglob("*.py"):
        assert not re.search(r"^\s*(import|from)\s+triton", path.read_text(), re.M), path
