"""The port's examples (admm_tpu_torch/examples/), the ports of the
single-device cases of tests/test_examples.py: each example run through
admm_tpu's (examples/) and the port's on the same seeds at the same small
sizes in f64, with the original test's own checks on the port's output and
the two outputs held together: equal step counts and flags, values to
1e-9 relative unless a case states another bar; ``train_all_digits`` on a
lanes x shards mesh too (tests/test_torch_mesh_examples.py has the other
mesh examples)."""

import struct
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import examples.acceleration as j_acc  # noqa: E402
import examples.convergencechecking as j_cc  # noqa: E402
import examples.fasteradmmcomparison as j_fast  # noqa: E402
import examples.hnormdemo as j_hn  # noqa: E402
import examples.maxcut as j_mc  # noqa: E402
import examples.mnistsvm as j_mnist  # noqa: E402
import examples.mpc_qp as j_mpc  # noqa: E402
import examples.portfolio as j_pf  # noqa: E402
import examples.relaxationexample as j_rel  # noqa: E402
import examples.stepsizetesting as j_step  # noqa: E402
from admm_tpu_torch.examples import (acceleration, convergencechecking,  # noqa: E402
                                     fasteradmmcomparison, hnormdemo, maxcut, mnistsvm, mpc_qp,
                                     portfolio, relaxationexample, stepsizetesting)

torch.set_num_threads(1)
CPU = dict(device="cpu")


def _close(a, b, rtol=1e-9, atol=0.0):
    np.testing.assert_allclose(np.asarray(a, float), np.asarray(b, float), rtol=rtol, atol=atol)


def test_convergencechecking_catches_broken_proxes():
    out = convergencechecking.convergencechecking(48, 32, quiet=True, **CPU)
    assert not out["ok-f / ok-g"].diverged
    assert out["BROKEN-f / BROKEN-g"].diverged
    ref = j_cc.convergencechecking(48, 32, quiet=True)
    for name, res in out.items():
        assert (res.steps, bool(res.diverged)) == (int(ref[name].steps), bool(ref[name].diverged))
        _close(res.Hnormsq, ref[name].Hnormsq, 1e-8)


def test_fasteradmmcomparison_runs():
    out = fasteradmmcomparison.fasteradmmcomparison(64, 48, quiet=True, maxiters=3000, **CPU)
    steps_std, xerr_std, _ = out["standard"]
    steps_fast, xerr_fast, _ = out["fast (strong)"]
    assert xerr_std < 1e-2 and xerr_fast < 1e-2
    assert steps_fast <= steps_std
    ref = j_fast.fasteradmmcomparison(64, 48, quiet=True, maxiters=3000)
    for name in ("standard", "fast (strong)"):
        assert out[name][0] == int(ref[name][0]), name
        _close(out[name][1], ref[name][1], 1e-6)
    # Accelerated ADMM with restart reaches the f64 noise floor in both,
    # where its restarts and d-value stop follow rounding (ROADMAP.md
    # queue 3, deliberate differences): the stop is not held, the floor is.
    name = "accelerated+restart (weak)"
    assert out[name][1] <= 1e-12 and ref[name][1] <= 1e-12


def test_stepsize_and_relaxation_studies():
    kw = dict(rhos=(0.5, 1.0), tester="model", quiet=True, rows=48, cols=48, errtol=1e-2)
    out = stepsizetesting.stepsizetesting(**kw, **CPU)
    assert all(ok for _, ok in out.values())
    assert all(steps > 0 for steps, _ in out.values())
    ref = j_step.stepsizetesting(**kw)
    assert {r: (s, ok) for r, (s, ok) in out.items()} == {
        r: (int(s), ok) for r, (s, ok) in ref.items()}
    kw = dict(relaxes=(1.0, 1.5), rows=256, cols=16, quiet=True)
    out2 = relaxationexample.relaxationexample(**kw, **CPU)
    assert all(xerr < 1e-2 for _, xerr in out2.values())
    ref2 = j_rel.relaxationexample(**kw)
    for relax, (steps, xerr) in out2.items():
        assert steps == int(ref2[relax][0])
        _close(xerr, ref2[relax][1], 1e-6)


def test_hnormdemo_runs():
    out = hnormdemo.hnormdemo(48, 32, quiet=True, **CPU)
    ref = j_hn.hnormdemo(48, 32, quiet=True)
    for stopcond, (steps, hfinal) in out.items():
        assert steps > 0 and np.isfinite(hfinal)
        assert steps == int(ref[stopcond][0])
        _close(hfinal, ref[stopcond][1], 1e-7)


def test_acceleration_example():
    out = acceleration.acceleration_ladder(rows=100, cols=200, quiet=True, **CPU)
    objs = [f for _, f in out.values()]
    assert max(objs) - min(objs) <= 1e-6 * (1.0 + abs(objs[0]))
    assert out["anderson m=10"][0] < out["plain"][0]
    ref = j_acc.acceleration_ladder(rows=100, cols=200, quiet=True)
    for name in ("plain", "fast"):  # no AA window: the same steps
        assert out[name][0] == ref[name][0], name
    for name, (_, f) in out.items():
        _close(f, ref[name][1], 1e-9)

    lp = acceleration.badly_scaled_lp(m=24, n=72, quiet=True, **CPU)
    for name in ("precondition", "precondition + AA"):
        steps, fobj, eq_viol, cone_viol = lp[name]
        assert eq_viol < 1e-6 and cone_viol < 1e-3
    assert lp["precondition + AA"][0] <= lp["precondition"][0]
    ref = j_acc.badly_scaled_lp(m=24, n=72, quiet=True)
    assert lp["precondition"][0] == ref["precondition"][0]
    _close(lp["precondition"][1], ref["precondition"][1], 1e-8)


def test_mnist_synthetic_pipeline():
    kw = dict(n_train=300, n_test=100, digits=[0, 1], maxiters=100, quiet=True)
    rows = mnistsvm.mnistsvm(**kw, **CPU)
    assert len(rows) == 2
    for digit, tr_h, te_h, tr_0, te_0 in rows:
        assert tr_h < 35.0
        assert 0.0 <= te_h <= 100.0
    # The hinge columns (a convex problem) equal admm_tpu's; the 0-1 loss
    # is not convex and its solve starts from the unwrapped solver's random
    # draw, which the port makes with torch and admm_tpu with jax.random.
    ref = j_mnist.mnistsvm(**kw)
    _close([r[:3] for r in rows], [r[:3] for r in ref], 0, 1e-9)


def test_mnist_batched_matches_serial_loop():
    kw = dict(n_train=200, n_test=80, digits=[0, 1, 2], maxiters=80, quiet=True, **CPU)
    batched = mnistsvm.mnistsvm(batched=True, **kw)
    serial = mnistsvm.mnistsvm(batched=False, **kw)
    for rb, rs in zip(batched, serial):
        np.testing.assert_allclose(rb, rs, atol=1e-9)


def test_mnist_train_all_digits_on_a_mesh_waits_for_slice_10():
    # train_all_digits(mesh=...) over the lanes x row-shards layout: the
    # twin of tests/test_examples.py::test_mnist_train_all_digits_on_2d_mesh,
    # and the separators at admm_tpu's (1e-9).
    from admm_tpu.parallel import make_mesh2d as j_mesh2d
    from admm_tpu_torch.parallel import make_mesh2d

    (tr_x, tr_y), _, _ = mnistsvm.load_mnist(None, 200, 50)
    D = tr_x.reshape(len(tr_x), -1)
    X = mnistsvm.train_all_digits(D, tr_y, [0, 1], maxiters=80,
                                  mesh=make_mesh2d(2, 4, device="cpu"), nshards=4, **CPU)
    assert X.shape == (2, D.shape[1]) and np.isfinite(X).all()
    for i, d in enumerate([0, 1]):
        ell = np.where(tr_y == d, 1.0, -1.0)
        err = 100.0 * np.mean(np.sign(D @ X[i]) != ell)
        assert err < 35.0, (d, err)
    ref = j_mnist.train_all_digits(D, tr_y, [0, 1], maxiters=80, mesh=j_mesh2d(2, 4),
                                   nshards=4)
    _close(X, ref, 0, 1e-9)


def test_mnist_data_equals_the_references():
    # The fully synthetic set (the fallback without label files) is the
    # reference's, bit for bit; the trained hinge separators agree to 1e-8.
    ours, ref = mnistsvm.synthetic_mnist(200, 50), j_mnist.synthetic_mnist(200, 50)
    for a, b in zip(ours, ref):
        for u, v in zip(a, b):
            np.testing.assert_array_equal(u, v)
    (tr_x, tr_y), _ = ours
    D = tr_x.reshape(len(tr_x), -1)
    X = mnistsvm.train_all_digits(D, tr_y, [0, 1, 2], maxiters=60, **CPU)
    _close(X, j_mnist.train_all_digits(D, tr_y, [0, 1, 2], maxiters=60), 1e-8, 1e-10)


def _reference_mnist_dir():
    """The directory admm_tpu's examples read real MNIST labels from, or a
    skip (the originals skip without the reference mount)."""
    d = next((p for p in j_mnist._DEFAULT_DATA_DIRS
              if (p / "train-labels.idx1-ubyte").exists()), None)
    if d is None:
        pytest.skip("reference MNIST labels not mounted")
    return d


def test_idx_label_parser_against_reference_file():
    path = _reference_mnist_dir() / "t10k-labels.idx1-ubyte"
    labels = mnistsvm.read_idx_labels(path)
    assert len(labels) == 10000
    np.testing.assert_array_equal(labels[:10], [7, 2, 1, 0, 4, 1, 4, 9, 5, 9])
    np.testing.assert_array_equal(np.bincount(labels),
                                  [980, 1135, 1032, 1010, 982, 892, 958, 1028, 974, 1009])
    tr = mnistsvm.read_idx_labels(path.with_name("train-labels.idx1-ubyte"))
    assert len(tr) == 60000
    np.testing.assert_array_equal(tr[:10], [5, 0, 4, 1, 9, 2, 1, 3, 1, 4])
    np.testing.assert_array_equal(labels, j_mnist.read_idx_labels(path))


def test_load_mnist_explicit_bad_dir_raises(tmp_path):
    with pytest.raises(FileNotFoundError, match="idx"):
        mnistsvm.load_mnist(data_dir=str(tmp_path / "nope"))


def test_load_mnist_defaults_to_real_labels():
    # The port reads nothing outside its checkout, so the reference mount
    # is passed as data_dir; admm_tpu finds it by default.
    d = _reference_mnist_dir()
    (tr_x, tr_y), (te_x, te_y), source = mnistsvm.load_mnist(d, n_train=400, n_test=150)
    assert source == "real-labels"
    assert tr_x.shape == (400, 20, 20) and te_x.shape == (150, 20, 20)
    assert set(np.unique(tr_y)) == set(range(10))
    assert set(np.unique(te_y)) <= set(range(10))
    (jx, jy), _, jsource = j_mnist.load_mnist(n_train=400, n_test=150)
    assert jsource == source
    np.testing.assert_array_equal(tr_x, jx)
    np.testing.assert_array_equal(tr_y, jy)


def test_idx_loader_round_trip(tmp_path):
    rng = np.random.default_rng(0)
    count, rows, cols, border = 7, 28, 28, 4
    imgs = rng.integers(0, 256, size=(count, rows, cols), dtype=np.uint8)
    labels = rng.integers(0, 10, size=count, dtype=np.uint8)
    img_path = tmp_path / "imgs.idx3-ubyte"
    with open(img_path, "wb") as f:
        f.write(struct.pack(">IIII", 0x00000803, count, rows, cols))
        f.write(imgs.tobytes())
    lab_path = tmp_path / "labels.idx1-ubyte"
    with open(lab_path, "wb") as f:
        f.write(struct.pack(">II", 0x00000801, count))
        f.write(labels.tobytes())

    out = mnistsvm.read_idx_images(img_path, border=border)
    assert out.shape == (count, rows - 2 * border, cols - 2 * border)
    np.testing.assert_allclose(out, imgs[:, border:rows - border, border:cols - border] / 255.0)
    np.testing.assert_array_equal(out, j_mnist.read_idx_images(img_path, border=border))
    np.testing.assert_array_equal(mnistsvm.read_idx_labels(lab_path), labels.astype(np.int64))

    with pytest.raises(ValueError, match="idx3"):
        mnistsvm.read_idx_images(lab_path)
    with pytest.raises(ValueError, match="idx1"):
        mnistsvm.read_idx_labels(img_path)
    bad = tmp_path / "bad.idx3-ubyte"
    with open(bad, "wb") as f:
        f.write(struct.pack("<IIII", 0x00000803, count, rows, cols))
        f.write(imgs.tobytes())
    with pytest.raises(ValueError, match="idx3"):
        mnistsvm.read_idx_images(bad)


def test_mpc_qp_warm_start_example():
    kw = dict(B=4, n=16, m=6, steps=4, maxiters=2000, quiet=True)
    cold, warm = mpc_qp.mpc_qp(**kw, **CPU)
    assert len(cold) == len(warm) == 4
    assert all(w < c for w, c in zip(warm[1:], cold[1:]))
    assert (cold, warm) == j_mpc.mpc_qp(**kw)


def test_portfolio_frontier():
    rows = portfolio.efficient_frontier(n_assets=16, n_gammas=6, maxiters=6000, quiet=True,
                                        **CPU)
    vols, rets = [r[2] for r in rows], [r[1] for r in rows]
    assert all(abs(r[3] - 1) < 1e-6 for r in rows)
    assert all(r[4] >= -1e-8 for r in rows)
    assert all(v2 <= v1 + 1e-9 for v1, v2 in zip(vols, vols[1:]))
    assert all(r2 <= r1 + 1e-6 for r1, r2 in zip(rets, rets[1:]))
    _close(rows, j_pf.efficient_frontier(n_assets=16, n_gammas=6, maxiters=6000, quiet=True),
           1e-8, 1e-12)


def test_maxcut_sdp_relaxation_and_rounding():
    rows = maxcut.maxcut_demo(n_nodes=16, n_graphs=3, quiet=True, **CPU)
    for _, sdp_val, cut, ratio, steps in rows:
        assert cut <= sdp_val + 1e-6
        assert ratio >= 0.878
        assert steps > 0
    ref = j_mc.maxcut_demo(n_nodes=16, n_graphs=3, quiet=True)
    assert [r[4] for r in rows] == [r[4] for r in ref]
    _close([r[:4] for r in rows], [r[:4] for r in ref], 1e-8)
