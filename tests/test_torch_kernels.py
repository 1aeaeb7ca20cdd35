"""Parity of the port's fused z/u pass (admm_tpu_torch/ops/kernels.py)
against admm_tpu's Pallas kernel (interpret mode) and its jnp twin.

The Triton kernel itself runs only on a CUDA device; its cases are in
tests/test_torch_gpu.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from admm_tpu.ops.kernels import _fused_jnp
from admm_tpu.ops.kernels import fused_soft_threshold_dual as jax_fused
from admm_tpu_torch.ops.kernels import _fused_torch, fused_soft_threshold_dual

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


def test_kernel_source_imports_without_building():
    # Triton is imported when the kernel is first built, never when the
    # module is imported, so this passes on hosts without Triton; the
    # block size must be a power of two for tl.arange.
    from admm_tpu_torch.ops import triton_fused_zu

    assert triton_fused_zu.BLOCK & (triton_fused_zu.BLOCK - 1) == 0
