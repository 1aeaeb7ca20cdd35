"""MNIST one-vs-all linear SVM via unwrapped ADMM (port of
``examples/mnistsvm.py``).

Mirrors reference examples/mnistsvm.m: read MNIST idx files (readMNIST,
mnistsvm.m:188-256: trim the 4px border to 20x20 = 400 features,
normalize /255), subsample train/test sets, train one linear SVM per
digit with hinge AND 0-1 loss (trainForDigit, mnistsvm.m:121-156), and
print a per-digit train/test error table (mnistsvm.m:86-113).

Nothing is downloaded.  Degradation order, as ``admm_tpu``'s: real images
and labels when a full idx set exists; the real labels with synthetic
images keyed to them when only the idx1 label files exist; fully
synthetic otherwise.  Without ``data_dir`` the port looks for the files
in ``examples/MNIST`` of this checkout only (it reads nothing outside its
checkout).  The readers and the synthetic images are this module's own
copies of ``examples/mnistsvm.py``'s, so a seed gives the same data.

Usage:  python -m admm_tpu_torch.examples.mnistsvm [--data DIR] [--train N]
        [--test N] [--device cpu]
"""

from __future__ import annotations

import argparse
import struct
from pathlib import Path

import numpy as np


def read_idx_images(path, border=4):
    """Parse an idx3-ubyte image file (the readMNIST logic,
    mnistsvm.m:188-256): trim ``border`` pixels per side, scale to [0,1]."""
    with open(path, "rb") as f:
        header = f.read(16)
        if len(header) < 16:
            raise ValueError(f"{path}: not an idx3-ubyte image file (truncated header)")
        magic, count, rows, cols = struct.unpack(">IIII", header)
        if magic != 0x00000803:
            raise ValueError(f"{path}: not an idx3-ubyte image file")
        data = np.frombuffer(f.read(), dtype=np.uint8)
    if data.size != count * rows * cols:
        raise ValueError(f"{path}: payload has {data.size} bytes, header promises "
                         f"{count}x{rows}x{cols}")
    imgs = data.reshape(count, rows, cols).astype(np.float64) / 255.0
    return imgs[:, border:rows - border, border:cols - border]


def read_idx_labels(path):
    """Parse an idx1-ubyte label file."""
    with open(path, "rb") as f:
        header = f.read(8)
        if len(header) < 8:
            raise ValueError(f"{path}: not an idx1-ubyte label file (truncated header)")
        magic, count = struct.unpack(">II", header)
        if magic != 0x00000801:
            raise ValueError(f"{path}: not an idx1-ubyte label file")
        labels = np.frombuffer(f.read(), dtype=np.uint8).astype(np.int64)
    if labels.size != count:
        raise ValueError(f"{path}: payload has {labels.size} labels, header promises {count}")
    return labels


# Where to look for idx files when no data_dir is given.
_DEFAULT_DATA_DIRS = (Path(__file__).resolve().parents[2] / "examples" / "MNIST",)


def _prototypes(side, seed):
    """One smooth random prototype per class + shared background: classes
    overlap (like real digits sharing strokes), so error rates are
    informative."""
    rng = np.random.default_rng(seed)
    shared = np.kron(rng.random((side // 4, side // 4)), np.ones((4, 4)))
    protos = []
    for d in range(10):
        delta = np.kron(rng.random((side // 4, side // 4)), np.ones((4, 4)))
        proto = 0.7 * shared + 0.3 * delta
        protos.append(proto / proto.max())
    return np.stack(protos)


def synthetic_images(labels, side=20, seed=0):
    """MNIST-shaped synthetic digit images keyed to the given labels."""
    rng = np.random.default_rng(seed)
    protos = _prototypes(side, seed)
    imgs = protos[labels] + 0.9 * rng.standard_normal((len(labels), side, side))
    return np.clip(imgs, 0, 1)


def synthetic_mnist(n_train=6000, n_test=1000, side=20, seed=0):
    """Fully synthetic fallback (random labels + keyed images)."""
    rng = np.random.default_rng(seed)
    tr_y = rng.integers(0, 10, size=n_train)
    te_y = rng.integers(0, 10, size=n_test)
    return ((synthetic_images(tr_y, side, seed), tr_y),
            (synthetic_images(te_y, side, seed + 1), te_y))


def load_mnist(data_dir=None, n_train=6000, n_test=1000, seed=0):
    """``((train_x, train_y), (test_x, test_y), source)`` with source
    'real' | 'real-labels' | 'synthetic' (see the module docstring).  An
    explicit ``data_dir`` must hold the label files, or this raises."""
    if data_dir is not None:
        d = Path(data_dir)
        if not (d / "train-labels.idx1-ubyte").exists():
            raise FileNotFoundError(
                f"{d}: no train-labels.idx1-ubyte; an explicit --data dir must hold MNIST "
                "idx files (omit --data for the synthetic fallback)")
    else:
        d = next((p for p in _DEFAULT_DATA_DIRS
                  if (p / "train-labels.idx1-ubyte").exists()), None)
        if d is None:
            return (*synthetic_mnist(n_train, n_test, seed=seed), "synthetic")

    tr_y = read_idx_labels(d / "train-labels.idx1-ubyte")
    te_y = read_idx_labels(d / "t10k-labels.idx1-ubyte")
    if (d / "train-images.idx3-ubyte").exists():
        tr_x = read_idx_images(d / "train-images.idx3-ubyte")
        te_x = read_idx_images(d / "t10k-images.idx3-ubyte")
        source = "real"
    else:
        tr_x = synthetic_images(tr_y, seed=seed)
        te_x = synthetic_images(te_y, seed=seed + 1)
        source = "real-labels"
    rng = np.random.default_rng(seed)
    tr_idx = rng.choice(len(tr_x), size=min(n_train, len(tr_x)), replace=False)
    te_idx = rng.choice(len(te_x), size=min(n_test, len(te_x)), replace=False)
    return (tr_x[tr_idx], tr_y[tr_idx]), (te_x[te_idx], te_y[te_idx]), source


def train_for_digit(D, labels, digit, C=0.5, rho=1.0, maxiters=500, loss="hinge",
                    device=None):
    """One-vs-all +/-1 labels -> linearsvm (trainForDigit, mnistsvm.m:121-156)."""
    from admm_tpu_torch import ADMMConfig, linearsvm
    from admm_tpu_torch.models._common import host64

    ell = np.where(labels == digit, 1.0, -1.0)
    res = linearsvm(D, ell, C, ADMMConfig(rho=rho, maxiters=maxiters, fast=False), loss=loss,
                    device=device)
    return host64(res.xopt)


def error_pct(D, labels, digit, x):
    ell = np.where(labels == digit, 1.0, -1.0)
    pred = np.sign(D @ x)
    return 100.0 * np.mean(pred != ell)


def train_all_digits(D, labels, digits, C=0.5, rho=1.0, maxiters=500, loss="hinge",
                     mesh=None, nshards=None, device=None):
    """All one-vs-all classifiers as the lanes of one ``svm_batch`` solve:
    the per-digit loop of mnistsvm.m:121-156 becomes one solve whose
    lanes differ only in the +/-1 label vector.  Pass a 2-D ``mesh``
    (``parallel.make_mesh2d``) to train over the lanes x row-shards layout
    instead (``parallel.svm_batch_sharded``): each classifier's rows in
    ``nshards`` shards, the classifiers over the lane axis (over the ranks
    of the mesh's process group, when it has one)."""
    from admm_tpu_torch import ADMMConfig, svm_batch
    from admm_tpu_torch.models._common import host64

    ells = np.stack([np.where(labels == d, 1.0, -1.0) for d in digits])
    cfg = ADMMConfig(rho=rho, maxiters=maxiters, fast=False)
    if mesh is not None:
        from admm_tpu_torch.parallel import svm_batch_sharded

        res = svm_batch_sharded(D, ells, C, cfg, loss=loss, mesh=mesh, nshards=nshards,
                                device=device)
    else:
        res = svm_batch(D, ells, C, cfg, loss=loss, device=device)
    return host64(res.xopt)


def mnistsvm(C=0.5, rho=1.0, n_test=1000, n_train=6000, data_dir=None, digits=range(10),
             maxiters=500, quiet=False, batched=True, device=None):
    """Per-digit train/test error table, hinge vs 0-1 loss
    (mnistsvm.m:86-113 defaults C=0.5, rho=1.0, 1000 test / 6000 train).

    ``batched=True`` (default) trains all ten classifiers per loss as the
    lanes of one solve; ``batched=False`` keeps the reference's serial
    per-digit loop (the same results)."""
    (tr_x, tr_y), (te_x, te_y), source = load_mnist(data_dir, n_train, n_test)
    if not quiet:
        print(f"data: {source} ({len(tr_x)} train / {len(te_x)} test)")
    Dtr = tr_x.reshape(len(tr_x), -1)
    Dte = te_x.reshape(len(te_x), -1)

    digits = list(digits)
    if batched:
        Xh = train_all_digits(Dtr, tr_y, digits, C, rho, maxiters, "hinge", device=device)
        X0 = train_all_digits(Dtr, tr_y, digits, C, rho, maxiters, "01", device=device)
    else:
        Xh = [train_for_digit(Dtr, tr_y, d, C, rho, maxiters, "hinge", device)
              for d in digits]
        X0 = [train_for_digit(Dtr, tr_y, d, C, rho, maxiters, "01", device) for d in digits]
    rows = []
    for i, digit in enumerate(digits):
        xh, x0 = Xh[i], X0[i]
        rows.append((digit,
                     error_pct(Dtr, tr_y, digit, xh), error_pct(Dte, te_y, digit, xh),
                     error_pct(Dtr, tr_y, digit, x0), error_pct(Dte, te_y, digit, x0)))
    if not quiet:
        print(f"{'digit':>5} {'hinge train%':>12} {'hinge test%':>12} "
              f"{'0-1 train%':>12} {'0-1 test%':>12}")
        for d, a, b, c_, e in rows:
            print(f"{d:>5} {a:>12.2f} {b:>12.2f} {c_:>12.2f} {e:>12.2f}")
    return rows


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--data", default=None, help="dir with MNIST idx files")
    ap.add_argument("--train", type=int, default=2000)
    ap.add_argument("--test", type=int, default=500)
    ap.add_argument("--device", default=None)
    a = ap.parse_args()
    mnistsvm(n_train=a.train, n_test=a.test, data_dir=a.data, device=a.device)
