"""Config-matrix fuzz of the port (admm_tpu_torch), the single-device
cases of tests/test_config_fuzz.py as parity cases: the same random valid
ADMMConfig (the same draws as ``_random_config`` there) and the same
instance through admm_tpu and the port in f64 must give equal step counts
and diverged/stalled flags, and a finite xopt equal to 1e-9 relative;
each result also passes the original's checks (steps within budget,
diverged or finite).  The consensus and exchange cases run the port's
distributed runners on a stacked CPU mesh of 4 shards against admm_tpu's
on its CPU mesh."""

import numpy as np
import pytest
import torch

import admm_tpu as J
import admm_tpu.parallel as JP
import admm_tpu_torch as T
import admm_tpu_torch.parallel as TP

torch.set_num_threads(1)


def _random_config(rng, aa_ok=True):
    """tests/test_config_fuzz.py's ``_random_config`` as keyword arguments
    (the same draws in the same order)."""
    cfg = dict(
        rho=float(rng.choice([0.5, 1.0, 2.0])),
        maxiters=int(rng.choice([60, 150])),
        relax=float(rng.choice([1.0, 1.0, 0.7, 1.5])),
        unroll=int(rng.choice([1, 1, 3, 4])),
        nanguard=bool(rng.random() < 0.5),
        domaxiters=bool(rng.random() < 0.2),
        stallwindow=int(rng.choice([0, 0, 0, 30])),
        quiet=True,
    )
    modes = ["plain", "fast_w", "fast_s", "adaptive", "rb"] + (["aa"] if aa_ok else [])
    mode = rng.choice(modes)
    if mode == "fast_w":
        cfg.update(fast=True, fasttype="weak")
    elif mode == "fast_s":
        cfg.update(fast=True, fasttype="strong")
    elif mode == "adaptive":
        cfg.update(adaptive=True, convtest=True)
    elif mode == "rb":
        cfg.update(rbadaptive=True)
    elif mode == "aa":
        cfg.update(anderson=int(rng.choice([2, 5, 12])))
    cfg["stopcond"] = str(rng.choice(
        ["standard", "both"] + (["hnorm"] if mode != "fast_w" else []))) if mode != "aa" \
        else "standard"
    if mode == "adaptive":
        cfg["stopcond"] = "both"
    return cfg


def _same(res_t, res_j, maxiters, x="xopt"):
    steps = int(res_t.steps)
    assert 1 <= steps <= maxiters
    assert (steps, bool(res_t.diverged), bool(res_t.stalled)) == (
        int(res_j.steps), bool(res_j.diverged), bool(res_j.stalled))
    got, ref = getattr(res_t, x).cpu().numpy(), np.asarray(getattr(res_j, x))
    assert bool(res_t.diverged) or np.all(np.isfinite(got))
    if not res_t.diverged:
        np.testing.assert_allclose(got, ref, rtol=1e-9, atol=1e-9 * np.max(np.abs(ref)))


@pytest.mark.parametrize("trial", range(12))
def test_random_config_new_families_never_crash(trial):
    rng = np.random.default_rng(2000 + trial)
    kw = _random_config(rng)
    cj, ct = J.ADMMConfig(**kw), T.ADMMConfig(**kw)
    fam = ("quantile", "rpca", "fusedlasso")[trial % 3]
    if fam == "quantile":
        D = rng.standard_normal((48, 12))
        s = rng.standard_normal(48)
        tau = float(rng.choice([0.3, 0.5, 0.8]))
        res_j, res_t = J.quantile(D, s, tau, cj), T.quantile(D, s, tau, ct, device="cpu")
    elif fam == "rpca":
        L0 = rng.standard_normal((20, 3)) @ rng.standard_normal((3, 16))
        S0 = (rng.random((20, 16)) < 0.05) * rng.standard_normal((20, 16))
        res_j, res_t = J.rpca(L0 + S0, config=cj), T.rpca(L0 + S0, config=ct, device="cpu")
    else:
        sig = np.repeat(rng.standard_normal(4), 12) + 0.3 * rng.standard_normal(48)
        res_j, res_t = J.fusedlasso(sig, 0.2, 0.4, cj), T.fusedlasso(sig, 0.2, 0.4, ct,
                                                                    device="cpu")
    _same(res_t, res_j, kw["maxiters"])


@pytest.mark.parametrize("trial", range(8))
def test_random_config_consensus_never_crashes_or_lies(trial):
    rng = np.random.default_rng(2000 + trial)
    kw = _random_config(rng)
    D = rng.standard_normal((64, 12))
    s = rng.standard_normal(64)
    res_j = JP.consensus_lasso(D, s, 0.1, J.ADMMConfig(**kw), nshards=4)
    res_t = TP.consensus_lasso(D, s, 0.1, T.ADMMConfig(**kw),
                               mesh=TP.make_mesh(4, device="cpu"))
    _same(res_t, res_j, kw["maxiters"], x="zopt")
    if kw["domaxiters"] and not res_t.diverged and T.ADMMConfig(**kw).alg != 2:
        assert res_t.steps == kw["maxiters"]


@pytest.mark.parametrize("trial", range(8))
def test_random_config_round4_families_never_crash(trial):
    # The sdp (even trials) and exchange (odd trials) halves.
    from admm_tpu.models.sdp import random_sdp_instance

    rng = np.random.default_rng(4000 + trial)
    kw = _random_config(rng)
    if trial % 2 == 0:
        C, A, b, *_ = random_sdp_instance(8, 5, 3, np.random.default_rng(trial))
        pm = ("eigh", "ns")[trial % 4 == 2]
        res_j = J.sdp(C, A, b, config=J.ADMMConfig(**kw), prox_method=pm)
        res_t = T.sdp(C, A, b, config=T.ADMMConfig(**kw), prox_method=pm, device="cpu")
    else:
        As = rng.standard_normal((4, 10, 5))
        bs = rng.standard_normal((4, 10))
        res_j = JP.exchange_quadratic(As, bs, config=J.ADMMConfig(**kw))
        res_t = TP.exchange_quadratic(As, bs, config=T.ADMMConfig(**kw),
                                      mesh=TP.make_mesh(8, device="cpu"))
    _same(res_t, res_j, kw["maxiters"])
