"""The cases of tests/test_torch_ranks_parity.py, in a module without JAX
so that its two-rank workers can import them: the data (made from seed 0)
and, per case, the runner call over a package P (``admm_tpu.parallel`` or
``admm_tpu_torch.parallel``), its config keywords and whether only a
prefix of its histories is held."""

import numpy as np

from admm_tpu_torch.models.sdp import random_sdp_instance

W = 8


def _data():
    rng = np.random.default_rng(0)
    D = rng.standard_normal((203, 12))
    s = D @ (rng.standard_normal(12) * (rng.random(12) < 0.5)) + 0.1 * rng.standard_normal(203)
    ell = np.sign(rng.standard_normal(203))
    As, bs = rng.standard_normal((W, 12, 6)), rng.standard_normal((W, 12))
    C, A, b, *_ = random_sdp_instance(8, 10, 3, rng)
    Dc = rng.standard_normal((96, 6))
    S = rng.standard_normal((4, 203))
    z0, u0 = rng.standard_normal(203), rng.standard_normal(203)
    return dict(D=D, s=s, ell=ell, As=As, bs=bs, C=C, A=A, b=b, Dc=Dc, S=S, z0=z0, u0=u0)


# name -> (runner expression over the package P (admm_tpu or the port),
# config keywords, the histories held, whether a prefix is held instead of
# the whole run).  ``mesh`` is the package's mesh of 8 shards.
CASES = {
    "consensus": ("P.consensus_lasso(d['D'], d['s'], 0.6, cfg, mesh=mesh)", {}, False),
    "consensus_relax": ("P.consensus_lasso(d['D'], d['s'], 0.6, cfg, mesh=mesh)",
                        dict(relax=1.5), False),
    "consensus_fast_strong": ("P.consensus_lasso(d['D'], d['s'], 0.6, cfg, mesh=mesh)",
                              dict(fast=True, fasttype="strong"), False),
    "consensus_fast_weak": ("P.consensus_lasso(d['D'], d['s'], 0.6, cfg, mesh=mesh)",
                            dict(fast=True), True),
    "consensus_anderson": ("P.consensus_lasso(d['D'], d['s'], 0.6, cfg, mesh=mesh)",
                           dict(anderson=3), False),
    "consensus_rbadaptive": ("P.consensus_lasso(d['D'], d['s'], 0.6, cfg, mesh=mesh)",
                             dict(rbadaptive=True), False),
    "consensus_hnorm": ("P.consensus_lasso(d['D'], d['s'], 0.6, cfg, mesh=mesh)",
                        dict(stopcond="both", convtest=True), False),
    "elasticnet": ("P.consensus_elasticnet(d['D'], d['s'], 0.6, 0.4, cfg, mesh=mesh)", {},
                   False),
    "logreg": ("P.consensus_logreg(d['D'], d['ell'], 0.6, cfg, mesh=mesh)",
               dict(maxiters=300), False),
    "covsel": ("P.consensus_covsel(d['Dc'], 0.1, cfg, mesh=mesh)",
               dict(abstol=1e-8, reltol=1e-8), False),
    "svm": ("P.linearsvm_sharded(d['D'], d['ell'], 1.0, cfg, mesh=mesh, x0=np.zeros(12), "
            "z0=d['z0'], u0=d['u0'])", dict(maxiters=400), False),
    "svm_relax": ("P.linearsvm_sharded(d['D'], d['ell'], 1.0, cfg, mesh=mesh, x0=np.zeros(12), "
                  "z0=d['z0'], u0=d['u0'])", dict(maxiters=400, relax=1.5), False),
    "svm_fast_strong": ("P.linearsvm_sharded(d['D'], d['ell'], 1.0, cfg, mesh=mesh, "
                        "x0=np.zeros(12), z0=d['z0'], u0=d['u0'])",
                        dict(maxiters=300, fast=True, fasttype="strong"), True),
    "exchange": ("P.exchange_quadratic(d['As'], d['bs'], cfg, mesh=mesh)",
                 dict(abstol=1e-9, reltol=1e-9), False),
    "exchange_relax": ("P.exchange_quadratic(d['As'], d['bs'], cfg, mesh=mesh)",
                       dict(abstol=1e-9, reltol=1e-9, relax=1.5), False),
    "exchange_anderson": ("P.exchange_quadratic(d['As'], d['bs'], cfg, mesh=mesh)",
                          dict(abstol=1e-9, reltol=1e-9, anderson=3), False),
    "exchange_fast_weak": ("P.exchange_quadratic(d['As'], d['bs'], cfg, mesh=mesh)",
                           dict(abstol=1e-9, reltol=1e-9, fast=True), True),
    "sdp": ("P.sdp_sharded(d['C'], d['A'], d['b'], cfg, mesh=mesh)",
            dict(abstol=1e-8, reltol=1e-8), False),
}

BASE = dict(maxiters=3000)
