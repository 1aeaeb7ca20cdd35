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


def assert_same_lanes(out, jout, rtol=1e-9):
    """A batched run of admm_tpu_torch (``BatchResults``/``PathResults``)
    against admm_tpu's, lane by lane: equal steps; x, z, u to ``rtol`` of
    the lane's largest entry (u at the scale of z, as in
    ``assert_same_run``); objopt to ``rtol``; pnorm, dnorm and objvals over
    each lane's steps to 1e-8 of their first value (of their largest where
    the first is zero to rounding)."""
    steps = np.asarray(jout.steps)
    assert out.steps.tolist() == steps.tolist()
    for i in range(steps.shape[0]):
        zscale = np.max(np.abs(np.asarray(jout.zopt[i])))
        for name in ("xopt", "zopt", "uopt"):
            ref = np.asarray(getattr(jout, name)[i])
            scale = max(np.max(np.abs(ref)), zscale if name == "uopt" else 0.0)
            np.testing.assert_allclose(getattr(out, name)[i].cpu().numpy(), ref, rtol=rtol,
                                       atol=rtol * scale)
        if jout.objopt is not None and not isinstance(jout.objopt, tuple):
            np.testing.assert_allclose(float(out.objopt[i]), float(jout.objopt[i]), rtol=rtol,
                                       atol=rtol)
        for name in ("pnorm", "dnorm", "objvals"):
            if name not in jout.hist:
                continue
            ref = np.asarray(jout.hist[name][i])[: steps[i]]
            got = out.hist[name][i].cpu().numpy()[: steps[i]]
            if np.isnan(ref).all():
                assert np.isnan(got).all()
                continue
            # The first value, unless it is zero to rounding (the max-cut
            # SDP's first pnorm): then the largest.
            top = np.max(np.abs(ref))
            scale = abs(ref[0]) if abs(ref[0]) > 1e-12 * top else top
            np.testing.assert_allclose(got, ref, rtol=0, atol=1e-8 * scale)


def assert_lane_is_solo(out, i, solo, rtol=1e-9, name="xopt"):
    """Lane ``i`` of a batched run of the port against the port's serial
    solve of the same instance: equal steps, ``name`` to ``rtol`` of its
    largest entry."""
    assert int(out.steps[i]) == solo.steps
    ref = getattr(solo, name).cpu().numpy()
    np.testing.assert_allclose(getattr(out, name)[i].cpu().numpy(), ref, rtol=rtol,
                               atol=rtol * np.max(np.abs(ref)))
