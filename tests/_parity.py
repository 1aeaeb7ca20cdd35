"""The parity bar of the port's tests of slices 3 and 4: a run of
admm_tpu_torch held against admm_tpu's run on the same inputs in f64."""

import numpy as np


def assert_same_run(res, jres, rtol=1e-9):
    """Equal steps and flags, rho_final to 1e-12, the iterates to ``rtol``
    and the histories to 1e-8 of their first value (of their largest where
    the first is 0; a trace that is NaN throughout, dnorm under
    ``nodualerror``, stays NaN).  u is held at the scale of z, with which
    it shares the constraint space: where the optimum's scaled dual is ~0
    (the SVM wherever its prox leaves D x + u unclipped), u's own scale is
    rounding noise."""
    assert res.steps == jres.steps
    assert (res.diverged, res.stalled) == (bool(jres.diverged), bool(jres.stalled))
    np.testing.assert_allclose(res.rho_final, float(jres.rho_final), rtol=1e-12)
    zscale = np.max(np.abs(np.asarray(jres.zopt)))
    for name in ("xopt", "zopt", "uopt"):
        ref = np.asarray(getattr(jres, name))
        scale = max(np.max(np.abs(ref)), zscale if name == "uopt" else 0.0)
        np.testing.assert_allclose(getattr(res, name).numpy(), ref, rtol=rtol, atol=rtol * scale)
    for name in ("pnorm", "dnorm", "objvals", "Hnormsq"):
        if name not in jres.hist:
            continue
        ref = jres.trace(name)
        if np.isnan(ref).all():
            assert np.isnan(res.trace(name)).all()
            continue
        scale = abs(ref[0]) or np.max(np.abs(ref))
        np.testing.assert_allclose(res.trace(name), ref, rtol=0, atol=1e-8 * scale)
