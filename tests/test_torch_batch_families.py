"""Instance batches of the port (admm_tpu_torch/models/batch.py), the ports of
the ``*_batch`` cases of tests/test_extra_models.py (elastic net, group
lasso, NNLS, quantile regression, robust PCA, the fused lasso) and of
tests/test_matrixcompletion.py's batch cases, plus the SDP's lanes: every
lane held against admm_tpu's batched result on the same numpy inputs in
f64 (``_parity.assert_same_lanes``: equal steps, iterates to rtol 1e-9,
histories to 1e-8 of their first value) and against the port's serial
solve (``_parity.assert_lane_is_solo``: equal steps, rtol 1e-9), unless a
test states another bar."""

import numpy as np
import pytest
import torch

import admm_tpu as J
import admm_tpu_torch as T

from _parity import assert_lane_is_solo, assert_same_lanes
from test_torch_batch import _both, _cfg

torch.set_num_threads(1)


def _instance(rng, m=60, n=30, sparsity=0.4):
    D = rng.standard_normal((m, n))
    xtrue = rng.standard_normal(n) * (rng.random(n) < sparsity)
    return D, D @ xtrue + 0.05 * rng.standard_normal(m)


def test_elasticnet_batch_matches_serial():
    rng = np.random.default_rng(0)
    D, _ = _instance(rng, m=40, n=24)
    S = rng.standard_normal((3, 40))
    lams, alphas = np.array([0.3, 0.6, 0.9]), np.array([0.2, 0.5, 1.0])
    cfg = _cfg(maxiters=3000)
    out, jout = _both("elasticnet_batch", D, S, lams, alphas, cfg=cfg)
    assert_same_lanes(out, jout)
    for i in range(3):
        solo = T.elasticnet(D, S[i], float(lams[i]), float(alphas[i]), config=cfg[0],
                            device="cpu")
        assert_lane_is_solo(out, i, solo)
    with pytest.raises(ValueError, match="alpha"):
        T.elasticnet_batch(D, S[:2], 0.5, np.array([0.5, 1.5]), device="cpu")


def test_grouplasso_batch_matches_serial():
    rng = np.random.default_rng(0)
    D, _ = _instance(rng, m=40, n=24)
    S = rng.standard_normal((2, 40))
    lengths = [10, 6, 8]
    cfg = _cfg(maxiters=3000)
    out = T.grouplasso_batch(D, S, 0.8, lengths, config=cfg[0], device="cpu")
    jout = J.grouplasso_batch(D, S, 0.8, lengths, config=cfg[1])
    assert_same_lanes(out, jout)
    for i in range(2):
        assert_lane_is_solo(out, i, T.grouplasso(D, S[i], 0.8, lengths, config=cfg[0],
                                                 device="cpu"))


def test_nnls_batch_matches_serial():
    rng = np.random.default_rng(0)
    D, _ = _instance(rng, m=40, n=24)
    S = rng.standard_normal((3, 40))
    cfg = _cfg(maxiters=5000)
    out, jout = _both("nnls_batch", D, S, cfg=cfg)
    assert_same_lanes(out, jout)
    for i in range(3):
        assert_lane_is_solo(out, i, T.nnls(D, S[i], config=cfg[0], device="cpu"), name="zopt")
    assert np.all(out.zopt.numpy() >= 0)


def test_quantile_batch_per_lane_taus_match_solo():
    rng = np.random.default_rng(0)
    D, s = _instance(rng, m=80, n=12)
    taus = np.array([0.2, 0.5, 0.8])
    cfg = _cfg(maxiters=8000, abstol=1e-11, reltol=1e-11)
    out = T.quantile_batch(D, s, taus, config=cfg[0], device="cpu")
    jout = J.quantile_batch(D, s, taus, config=cfg[1])
    assert_same_lanes(out, jout)
    for i, tau in enumerate(taus):
        assert_lane_is_solo(out, i, T.quantile(D, s, float(tau), cfg[0], device="cpu"))
    with pytest.raises(ValueError, match="tau"):
        T.quantile_batch(D, s, np.array([0.5, 1.0]), device="cpu")


def _plant(rng, m, n, r, frac=0.05, amp=5.0):
    L0 = rng.standard_normal((m, r)) @ rng.standard_normal((r, n))
    return L0, (rng.random((m, n)) < frac) * (amp * rng.standard_normal((m, n)))


def test_rpca_batch_matches_serial():
    rng = np.random.default_rng(0)
    Ms = np.stack([sum(_plant(rng, 24, 20, 2)) for _ in range(3)])
    cfg = _cfg(maxiters=2000, abstol=1e-9, reltol=1e-9)
    out = T.rpca_batch(Ms, config=cfg[0], device="cpu")
    jout = J.rpca_batch(Ms, config=cfg[1])
    assert_same_lanes(out, jout)
    for i in range(3):
        assert_lane_is_solo(out, i, T.rpca(Ms[i], config=cfg[0], device="cpu"))
        np.testing.assert_allclose(out.xopt[i].numpy() + out.zopt[i].numpy(), Ms[i], atol=1e-5)


def test_rpca_batch_rsvd_matches_serial_rsvd():
    # The lanes share the port's own G (its random stream), so they are
    # held against the port's serial rsvd solve, and against admm_tpu's
    # rsvd lanes where the sketch is exact (rank 2 <= k = 15): rtol 1e-7.
    rng = np.random.default_rng(1)
    Ms = np.stack([sum(_plant(rng, 40, 32, 2)) for _ in range(2)])
    cfg = _cfg(maxiters=2000, abstol=1e-9, reltol=1e-9)
    out = T.rpca_batch(Ms, config=cfg[0], prox_method="rsvd", rank=5, device="cpu")
    jout = J.rpca_batch(Ms, config=cfg[1], prox_method="rsvd", rank=5)
    for i in range(2):
        assert_lane_is_solo(out, i, T.rpca(Ms[i], config=cfg[0], prox_method="rsvd", rank=5,
                                           device="cpu"))
        np.testing.assert_allclose(out.xopt[i].numpy(), np.asarray(jout.xopt[i]), rtol=0,
                                   atol=1e-7 * np.abs(Ms[i]).max())


def test_matrixcompletion_batch_matches_serial_per_lane():
    rng = np.random.default_rng(0)
    lanes = []
    for _ in range(3):
        A, Bm = rng.standard_normal((24, 2)), rng.standard_normal((20, 2))
        lanes.append((A @ Bm.T, rng.random((24, 20)) < 0.75))
    Ms = np.stack([M * k for M, k in lanes])
    masks = np.stack([k for _, k in lanes])
    cfg = _cfg(maxiters=800, abstol=1e-10, reltol=1e-8)
    out = T.matrixcompletion_batch(Ms, masks, config=cfg[0], device="cpu")
    jout = J.matrixcompletion_batch(Ms, masks, config=cfg[1])
    assert_same_lanes(out, jout)
    for b, (M0, mask) in enumerate(lanes):
        solo = T.matrixcompletion(M0 * mask, mask, config=cfg[0], device="cpu")
        assert_lane_is_solo(out, b, solo, name="zopt")


def test_matrixcompletion_batch_per_lane_mu():
    rng = np.random.default_rng(1)
    A, Bm = rng.standard_normal((24, 2)), rng.standard_normal((20, 2))
    M0, mask = A @ Bm.T, rng.random((24, 20)) < 0.7
    Ms, masks = np.stack([M0 * mask, M0 * mask]), np.stack([mask, mask])
    cfg = _cfg(maxiters=600, abstol=1e-10, reltol=1e-8)
    out = T.matrixcompletion_batch(Ms, masks, mu=np.array([5.0, 500.0]), config=cfg[0],
                                   device="cpu")
    jout = J.matrixcompletion_batch(Ms, masks, mu=np.array([5.0, 500.0]), config=cfg[1])
    assert_same_lanes(out, jout)
    for b, mu in enumerate((5.0, 500.0)):
        solo = T.matrixcompletion(M0 * mask, mask, mu=mu, config=cfg[0], device="cpu")
        assert_lane_is_solo(out, b, solo, name="zopt")


def test_fusedlasso_batch_matches_serial():
    rng = np.random.default_rng(0)
    n = 80
    S = np.stack([np.repeat(rng.standard_normal(n // 20), 20) + 0.3 * rng.standard_normal(n)
                  for _ in range(3)])
    l1s, l2s = np.array([0.1, 0.3, 0.0]), np.array([0.5, 0.2, 0.7])
    cfg = _cfg(maxiters=6000, abstol=1e-10, reltol=1e-10)
    out = T.fusedlasso_batch(S, l1s, l2s, config=cfg[0], device="cpu")
    jout = J.fusedlasso_batch(S, l1s, l2s, config=cfg[1])
    assert_same_lanes(out, jout)
    for i in range(3):
        assert_lane_is_solo(out, i, T.fusedlasso(S[i], float(l1s[i]), float(l2s[i]), cfg[0],
                                                 device="cpu"))


@pytest.mark.parametrize("method", ["eigh", "ns"])
def test_sdp_batch_matches_serial(method):
    # Max-cut relaxations of three graphs (A='diag', b = 1) through
    # admm_tpu's and the port's sdp_batch and the port's serial sdp.
    rng = np.random.default_rng(5)
    n = 12
    Cs = []
    for _ in range(3):
        W = np.triu((rng.random((n, n)) < 0.4) * rng.random((n, n)), 1)
        W = W + W.T
        Cs.append(-(np.diag(W.sum(1)) - W) / 4.0)
    Cs = np.stack(Cs)
    cfg = _cfg(maxiters=300)
    out = T.sdp_batch(Cs, "diag", np.ones(n), cfg[0], prox_method=method, device="cpu")
    jout = J.sdp_batch(Cs, "diag", np.ones(n), cfg[1], prox_method=method)
    assert_same_lanes(out, jout)
    for i in range(3):
        solo = T.sdp(Cs[i], "diag", np.ones(n), cfg[0], prox_method=method, device="cpu")
        assert_lane_is_solo(out, i, solo)
