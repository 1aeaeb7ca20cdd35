"""The port on a CUDA device: the Triton z/u kernel against its plain
PyTorch version, and the LASSO slice going through it.

Every case needs a CUDA device and skips without one.  This file imports
no JAX, so it also runs where JAX is not installed; skip the repo's
conftest (which imports JAX) there:

    python -m pytest tests/test_torch_gpu.py -m gpu --noconftest -p no:cacheprovider
"""

import numpy as np
import pytest
import torch

from admm_tpu_torch import ADMMConfig, lasso
from admm_tpu_torch.ops.kernels import _fused_torch, fused_soft_threshold_dual

torch.set_num_threads(1)
pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.fixture
def launches(monkeypatch):
    monkeypatch.setattr(fused_soft_threshold_dual, "launches", 0)
    return lambda: fused_soft_threshold_dual.launches


def _vectors(n, dev, dtype, seed=2):
    rng = np.random.default_rng(seed)
    return (torch.from_numpy(rng.standard_normal(n)).to(dev, dtype),
            torch.from_numpy(rng.standard_normal(n)).to(dev, dtype))


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("n", [1, 64, 1000, 5000, 8192, 70000])
def test_triton_kernel_matches_twin(cuda, launches, n, dtype):
    x, u = _vectors(n, cuda, dtype)
    t = torch.tensor(0.37, dtype=dtype, device=cuda)
    u_before = u.clone()
    z_k, u_k = fused_soft_threshold_dual(x, u, t)
    torch.cuda.synchronize()
    assert launches() == 1
    z_t, u_t = _fused_torch(x, u, t)
    # Same rounding by construction (triton_fused_zu.py docstring): exact.
    assert torch.equal(z_k, z_t) and torch.equal(u_k, u_t)
    assert torch.equal(u, u_before)  # out of place


def test_triton_kernel_edge_values(cuda):
    # Exactly at the threshold, signed zeros, infinities and NaN.
    t = torch.tensor(0.5, dtype=torch.float32, device=cuda)
    x = torch.tensor([0.25, -0.25, 0.0, -0.0, float("inf"), float("-inf"),
                      float("nan"), 1.0], device=cuda)
    u = torch.tensor([0.25, -0.25, 0.0, 0.0, 0.0, 0.0, 0.0, -2.0], device=cuda)
    z_k, u_k = fused_soft_threshold_dual(x, u, t)
    z_t, u_t = _fused_torch(x, u, t)
    # NaN where the plain version has NaN, equal values elsewhere.
    for k, ref in ((z_k, z_t), (u_k, u_t)):
        nan = torch.isnan(ref)
        assert torch.equal(torch.isnan(k), nan)
        assert torch.equal(k[~nan], ref[~nan])


def test_wrapper_refuses_what_the_kernel_does_not_take(cuda):
    x, u = _vectors(16, cuda, torch.float32)
    with pytest.raises(TypeError, match="0-d tensor"):
        fused_soft_threshold_dual(x, u, 0.3)
    with pytest.raises(ValueError, match="u is"):
        fused_soft_threshold_dual(x, u.double(), torch.tensor(0.3, device=cuda))
    with pytest.raises(TypeError, match="dtype"):
        h = x.half()
        fused_soft_threshold_dual(h, h, torch.tensor(0.3, device=cuda).half())


def test_lasso_on_gpu_goes_through_the_kernel(cuda, launches):
    rng = np.random.default_rng(2)
    D = rng.standard_normal((64, 128))
    D = D / np.sqrt(np.sum(D**2, axis=0, keepdims=True))
    s = D @ (rng.standard_normal(128) * (rng.random(128) < 0.6))
    lam = 0.1 * np.max(np.abs(D.T @ s))
    cfg = ADMMConfig(maxiters=47, domaxiters=True, unroll=4)
    res = lasso(D, s, lam, cfg, use_fused_kernel=True, device=cuda)
    assert res.steps == 47 and res.xopt.device.type == "cuda"
    # 12 chunks of 4 sub-steps: frozen sub-steps run the kernel too.
    assert launches() == 48
    cpu = lasso(D, s, lam, cfg, use_fused_kernel=True, device="cpu")
    # f64 on both devices; cuBLAS and the CPU BLAS sum in other orders.
    np.testing.assert_allclose(res.xopt.cpu().numpy(), cpu.xopt.numpy(),
                               rtol=1e-9, atol=1e-10)
    plain = lasso(D, s, lam, cfg, use_fused_kernel=False, device=cuda)
    assert launches() == 48
    np.testing.assert_allclose(plain.xopt.cpu().numpy(), cpu.xopt.numpy(),
                               rtol=1e-9, atol=1e-10)
