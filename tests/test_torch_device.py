"""The port's placement rule (admm_tpu_torch/device.py): a solve runs on
the CUDA device unless the caller asks for the CPU, with ``device=`` or
with tensors that lie there; without a card the default raises and never
falls back.  Whether a card is visible is patched inside each test."""

import numpy as np
import pytest
import torch

import admm_tpu_torch as T
from admm_tpu_torch import (ADMMConfig, admm, basispursuit, covarianceselection, elasticnet,
                            fusedlasso, get_prox_ops, grouplasso, huberfit, lad, lasso,
                            linearprogram, linearsvm, logreg, matrixcompletion, nnls,
                            quadraticprogram, quantile, rpca, sdp, totalvariation,
                            totalvariation2d, unwrappedadmm)
from admm_tpu_torch.device import resolve_device

torch.set_num_threads(1)


@pytest.fixture
def no_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def _problem(seed=0, m=12, n=30):
    rng = np.random.default_rng(seed)
    return rng.standard_normal((m, n)), rng.standard_normal(m)


_CFG = ADMMConfig(maxiters=3, domaxiters=True)
_D, _S = _problem()
_DS, _SS = _problem(3, 30, 12)  # skinny, for the normal-equations and SVM families
_ENTRIES = {
    "lasso": lambda **kw: lasso(_D, _S, 0.1, _CFG, **kw),
    "elasticnet": lambda **kw: elasticnet(_D, _S, 0.1, 0.5, _CFG, **kw),
    "nnls": lambda **kw: nnls(_D, _S, _CFG, **kw),
    "grouplasso": lambda **kw: grouplasso(_D, _S, 0.1, 3, None, _CFG, **kw),
    "totalvariation": lambda **kw: totalvariation(_S, 0.5, _CFG, **kw),
    "totalvariation2d": lambda **kw: totalvariation2d(_D, 0.5, _CFG, **kw),
    "admm": lambda **kw: admm(lambda x, z, u, rho: 0.5 * (z - u),
                              lambda x, z, u, rho: x + u, _CFG, m=8, **kw),
    "basispursuit": lambda **kw: basispursuit(_D, _S, _CFG, **kw),
    "fusedlasso": lambda **kw: fusedlasso(_S, 0.1, 0.2, _CFG, **kw),
    "lad": lambda **kw: lad(_DS, _SS, _CFG, **kw),
    "huberfit": lambda **kw: huberfit(_DS, _SS, _CFG, **kw),
    "quantile": lambda **kw: quantile(_DS, _SS, 0.3, _CFG, **kw),
    "linearsvm": lambda **kw: linearsvm(_DS, np.sign(_SS), 1.0, _CFG, **kw),
    "unwrappedadmm": lambda **kw: unwrappedadmm(lambda x, z, u, rho: z, _DS, _CFG, **kw),
    "linearprogram": lambda **kw: linearprogram(np.abs(_D[0]), np.abs(_D), _S, _CFG, **kw),
    "quadraticprogram": lambda **kw: quadraticprogram(_DS.T @ _DS, _SS[:12], 0.0, -np.ones(12),
                                                      np.ones(12), _CFG, **kw),
    "covarianceselection": lambda **kw: covarianceselection(_DS, 0.1, _CFG, **kw),
    "sdp": lambda **kw: sdp(_DS.T @ _DS, "diag", np.ones(12), _CFG, **kw),
    "rpca": lambda **kw: rpca(_D, config=_CFG, **kw),
    "matrixcompletion": lambda **kw: matrixcompletion(_D, _D > 0, config=_CFG, **kw),
    "logreg": lambda **kw: logreg(_DS, np.sign(_SS), 0.1, _CFG, **kw),
}
# The lanes' entry points (slice 8): every lane runs the 3 steps.
_LANES = {
    "lasso_batch": lambda **kw: T.lasso_batch(_D, np.stack([_S, -_S]), 0.1, _CFG, **kw),
    "tv_batch": lambda **kw: T.tv_batch(np.stack([_S, -_S]), 0.5, _CFG, **kw),
    "rpca_batch": lambda **kw: T.rpca_batch(np.stack([_D, -_D]), config=_CFG, **kw),
    "logreg_batch": lambda **kw: T.logreg_batch(_DS, np.sign(np.stack([_SS, -_SS])), 0.1, _CFG,
                                                **kw),
    "lasso_path": lambda **kw: T.lasso_path(_D, _S, [0.1, 0.2], _CFG, **kw),
    "tv_path": lambda **kw: T.tv_path(_S, [0.1, 0.2], _CFG, **kw),
    "qp_batch": lambda **kw: T.qp_batch(_DS.T @ _DS, np.stack([_SS[:12], -_SS[:12]]), 0.0,
                                        -np.ones(12), np.ones(12), _CFG, **kw),
}


@pytest.mark.parametrize("entry", sorted(_ENTRIES))
def test_numpy_inputs_without_a_device_need_the_card(no_card, entry):
    with pytest.raises(RuntimeError, match='device="cpu"'):
        _ENTRIES[entry]()


@pytest.mark.parametrize("entry", sorted(_ENTRIES))
def test_device_cpu_solves_on_the_cpu(no_card, entry):
    res = _ENTRIES[entry](device="cpu")
    assert res.steps == 3 and res.xopt.device.type == "cpu"


@pytest.mark.parametrize("entry", sorted(_LANES))
def test_lanes_without_a_device_need_the_card(no_card, entry):
    with pytest.raises(RuntimeError, match='device="cpu"'):
        _LANES[entry]()


@pytest.mark.parametrize("entry", sorted(_LANES))
def test_lanes_with_device_cpu_solve_on_the_cpu(no_card, entry):
    res = _LANES[entry](device="cpu")
    assert res.steps.tolist() == [3, 3] and res.xopt.device.type == "cpu"


def test_registry_places_like_a_solver(no_card):
    with pytest.raises(RuntimeError, match='device="cpu"'):
        get_prox_ops("basispursuit", D=_D, s=_S)
    pf, pg, obj = get_prox_ops("basispursuit", D=_D, s=_S, device="cpu")
    x = torch.zeros(30, dtype=torch.float64)
    assert pf(x, x, x, 1.0).device.type == "cpu"


def test_tensors_on_the_cpu_ask_for_the_cpu(no_card):
    D, s = (torch.from_numpy(a) for a in _problem(1))
    res = lasso(D, s, 0.1, _CFG)
    assert res.xopt.device.type == "cpu" and res.xopt.dtype == torch.float64
    sig = torch.from_numpy(_problem(2)[1])
    assert totalvariation(sig, 0.5, _CFG).xopt.device.type == "cpu"


def test_resolve_device_order(no_card, monkeypatch):
    t = torch.zeros(2)
    assert resolve_device("cpu") == torch.device("cpu")
    assert resolve_device(None, None, 1.0, {"a": 2.0, "b": t}) == t.device
    assert resolve_device("cuda:1", t) == torch.device("cuda", 1)  # explicit wins
    with pytest.raises(RuntimeError, match="none is visible"):
        resolve_device(None, np.zeros(2), 1.0)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    assert resolve_device(None, np.zeros(2)) == torch.device("cuda")
