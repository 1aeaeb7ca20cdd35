"""The port's string registry (admm_tpu_torch/models/__init__.py:
``register``, ``get_prox_ops``) and its input validation
(admm_tpu_torch/utils/validate.py: ``errorcheck``, ``slicemaker``)
against admm_tpu's: tests/test_registry.py, its all-problems case with
``sdp`` beside its ten, every ported family's registry closures against
admm_tpu's on the same inputs in f64,
tests/test_validation.py::test_mismatched_shapes_raise, and the rule that
the port imports neither JAX nor admm_tpu."""

import ast
from pathlib import Path

import numpy as np
import pytest
import torch

from admm_tpu.models import get_prox_ops as jax_get_prox_ops
from admm_tpu.utils.validate import errorcheck as jax_errorcheck
from admm_tpu.utils.validate import slicemaker as jax_slicemaker
from admm_tpu_torch import get_prox_ops, huberfit, lad, lasso, linearsvm
from admm_tpu_torch.models import _REGISTRY
from admm_tpu_torch.utils import errorcheck, slicemaker

torch.set_num_threads(1)
ROOT = Path(__file__).resolve().parents[1]


def _cases():
    """Per family: (keyword arguments, shape of x, shape of z and u)."""
    rng = np.random.default_rng(0)
    D = rng.standard_normal((32, 16))
    Dfat = rng.standard_normal((16, 32))
    s32, s16 = rng.standard_normal(32), rng.standard_normal(16)
    S = rng.standard_normal((12, 10))
    P = rng.standard_normal((16, 16))
    P = P @ P.T + 16 * np.eye(16)
    W = rng.standard_normal((40, 10))
    Csdp = rng.standard_normal((6, 6))
    Asdp = rng.standard_normal((4, 6, 6))
    return {
        "model": (dict(P=D, Q=D[::-1].copy(), r=s32, s=s32[::-1].copy()), (16,), (16,)),
        "lasso": (dict(D=D, s=s32, lam=0.1), (16,), (16,)),
        "elasticnet": (dict(D=D, s=s32, lam=0.3, alpha=0.4), (16,), (16,)),
        "nnls": (dict(D=D, s=s32), (16,), (16,)),
        "grouplasso": (dict(D=D, s=s32, lam=0.5, groups=4), (16,), (16,)),
        "basispursuit": (dict(D=Dfat, s=s16), (32,), (32,)),
        "totalvariation": (dict(s=s32, lam=1.0), (32,), (32,)),
        "totalvariation2d": (dict(S=S, lam=0.7), (12, 10), (2, 12, 10)),
        "fusedlasso": (dict(s=s32, lam1=0.2, lam2=0.4), (32,), (64,)),
        "lad": (dict(D=D, s=s32), (16,), (32,)),
        "huberfit": (dict(D=D, s=s32), (16,), (32,)),
        "quantile": (dict(D=D, s=s32, tau=0.3), (16,), (32,)),
        "linearsvm": (dict(D=D, ell=np.sign(s32), C=0.5), (16,), (32,)),
        "linearprogram": (dict(b=np.abs(s32), D=Dfat, s=s16), (32,), (32,)),
        "quadraticprogram": (dict(P=P, q=s16, D=Dfat[:8, :16], s=s16[:8], kkt_mode="chol"),
                             (16,), (16,)),
        "covarianceselection": (dict(S=np.cov(W, rowvar=False), lam=0.2), (10, 10), (10, 10)),
        "sdp": (dict(C=Csdp + Csdp.T, A=Asdp + np.swapaxes(Asdp, 1, 2), b=s16[:4]), (6, 6),
                (6, 6)),
        "rpca": (dict(M=S), (12, 10), (12, 10)),
        "matrixcompletion": (dict(M=S, mask=S > 0), (12, 10), (12, 10)),
        "logreg": (dict(D=D, ell=np.sign(s32), lam=0.1), (16,), (16,)),
    }


def test_registry_holds_every_ported_family():
    assert sorted(_REGISTRY) == sorted(_cases())


@pytest.mark.parametrize("family", sorted(_cases()))
def test_registry_closures_match_jax(family):
    kwargs, xs, zs = _cases()[family]
    pf, pg, obj = get_prox_ops(family, device="cpu", **kwargs)
    jpf, jpg, jobj = jax_get_prox_ops(family, **kwargs)
    rng = np.random.default_rng(1)
    x, z, u = rng.standard_normal(xs), rng.standard_normal(zs), rng.standard_normal(zs)
    tx, tz, tu = (torch.from_numpy(a) for a in (x, z, u))
    # Each package factorizes on its own in f64, so the x-proxes agree to
    # the conditioning of the setup; the others are elementwise.
    if family == "linearsvm":
        assert pf is None and jpf is None  # the x-update is unwrappedadmm's
    elif family == "quadraticprogram":
        assert obj is None and jobj is None  # the objective needs r: the solver's
    else:
        np.testing.assert_allclose(pf(tx, tz, tu, 1.3).numpy(), np.asarray(jpf(x, z, u, 1.3)),
                                   rtol=1e-9, atol=1e-12)
    got = pg(tx, tz, tu, 1.3)
    assert got.dtype == torch.float64 and got.device.type == "cpu"
    np.testing.assert_allclose(got.numpy(), np.asarray(jpg(x, z, u, 1.3)), rtol=1e-12,
                               atol=1e-13)
    if obj is not None:
        np.testing.assert_allclose(float(obj(tx, tz)), float(jobj(x, z)), rtol=1e-12)


def test_registry_all_problems_resolve():
    # tests/test_registry.py::test_registry_all_problems_resolve, its ten
    # cases and the SDP; each closure runs on the CPU.
    rng = np.random.default_rng(0)
    D = rng.standard_normal((32, 16))
    Dfat = rng.standard_normal((16, 32))
    s32, s16, n16 = rng.standard_normal(32), rng.standard_normal(16), rng.standard_normal(16)
    cases = {
        "model": dict(P=D, Q=D, r=s32, s=s32),
        "lasso": dict(D=D, s=s32, lam=0.1),
        "basispursuit": dict(D=Dfat, s=s16),
        "totalvariation": dict(s=s32, lam=1.0),
        "lad": dict(D=D, s=s32),
        "huberfit": dict(D=D, s=s32),
        "linearprogram": dict(b=n16, D=D, s=s32),
        "quadraticprogram": dict(P=np.eye(16), q=n16, lb=-np.ones(16), ub=np.ones(16)),
        "covarianceselection": dict(S=np.eye(16), lam=1.0),
        "linearsvm": dict(D=D, ell=np.sign(s32), C=0.5),
        "sdp": dict(C=np.eye(4), A="diag", b=np.ones(4)),
    }
    for name, args in cases.items():
        out = get_prox_ops(name, device="cpu", **args)
        assert len(out) >= 2, name
        if name != "linearsvm":
            assert callable(out[0]), name
        assert callable(out[1]), name
        jout = jax_get_prox_ops(name, **args)
        assert [f is None for f in out] == [f is None for f in jout], name


def test_registry_unknown_problem():
    with pytest.raises(ValueError, match="unknown problem") as port:
        get_prox_ops("nosuchproblem")
    assert "'lad'" in str(port.value) and "'linearsvm'" in str(port.value)


def test_registry_accepts_args_struct():
    """get_prox_ops(problem, args) with a struct (dict) second argument,
    validated by errorcheck('isstruct') (tests/test_registry.py)."""
    rng = np.random.default_rng(0)
    D = rng.standard_normal((32, 16))
    s = rng.standard_normal(32)
    pf, pg, obj = get_prox_ops("lasso", {"D": D, "s": s, "lam": 0.3, "device": "cpu"})
    z = torch.zeros(16, dtype=torch.float64)
    assert bool(torch.isfinite(pf(z, z, z, 1.0)).all())
    # Keywords win over the struct's entries.
    pf2, _, _ = get_prox_ops("lasso", {"D": D, "s": s, "lam": 0.3}, device="cpu")
    assert torch.equal(pf2(z, z, z, 1.0), pf(z, z, z, 1.0))
    with pytest.raises(ValueError, match="struct"):
        get_prox_ops("lasso", [("D", D)])


def test_registry_places_operands_like_a_solver(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    rng = np.random.default_rng(2)
    D, s = rng.standard_normal((20, 8)), rng.standard_normal(20)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        get_prox_ops("lad", D=D, s=s)
    _, pg, _ = get_prox_ops("lad", D=torch.from_numpy(D), s=s)  # a CPU tensor asks for the CPU
    z = torch.zeros(20, dtype=torch.float64)
    assert pg(torch.zeros(8, dtype=torch.float64), z, z, 1.0).device.type == "cpu"


_CHECKS = [
    (np.ones((2, 3)), "ismatrix", None), (np.ones(3), "ismatrix", None),
    (np.ones((3, 3)), "issquare", None), (np.ones((2, 3)), "issquare", None),
    (np.ones((2, 3)), "isfat", None), (np.ones((3, 2)), "isfat", None),
    (np.ones((3, 2)), "isskinny", None), (np.ones((2, 2)), "isskinny", None),
    (np.ones((1, 4, 1)), "isvector", None), (np.ones((2, 2)), "isvector", None),
    (np.ones((4, 1)), "isrowvector", None), (np.ones((2, 2)), "isrowvector", None),
    (np.ones((1, 4)), "iscolumnvector", None), (np.ones((2, 2)), "iscolumnvector", None),
    (3.5, "isnumber", None), (np.ones(2), "isnumber", None),
    (2.0 + 1j, "ispositivereal", None), (-1.0, "ispositivereal", None),
    (0.0, "isnonnegativereal", None), (-0.5, "isnonnegativereal", None),
    (4.0, "isinteger", None), (4.5, "isinteger", None), (np.ones(2), "isinteger", None),
    ({"a": 1}, "isstruct", None), ([1, 2], "isstruct", None),
    (0, "slices", {"slicelength": 10, "workers": 3}),
    (4, "slices", {"slicelength": 10, "workers": 3}),
    ([3, 3, 4], "slices", {"slicelength": 10, "workers": 2}),
    ([3, 3], "slices", {"slicelength": 10, "workers": 2}),
    (1.0, "nosuchcheck", None),
]


@pytest.mark.parametrize("arg,check,opts", _CHECKS)
def test_errorcheck_matches_jax(arg, check, opts):
    def run(fn):
        try:
            return "ok", fn(arg, check, "arg", opts=opts)
        except ValueError as e:
            return "raised", str(e)

    (kind, got), (jkind, want) = run(errorcheck), run(jax_errorcheck)
    assert kind == jkind
    if kind == "ok" and isinstance(want, np.ndarray):
        np.testing.assert_array_equal(got, want)
        assert got.shape == want.shape
    else:
        assert got == want and type(got) is type(want)


@pytest.mark.parametrize("slices,length,workers", [
    (0, 10, 4), (0, 3, 8), (3, 10, 1), (5, 10, 2), ([2, 8], 10, 2), (-1, 10, 2), (2, 10, 0),
])
def test_slicemaker_matches_jax(slices, length, workers):
    try:
        want = jax_slicemaker(slices, length, workers)
    except ValueError as e:
        with pytest.raises(ValueError, match=str(e)):
            slicemaker(slices, length, workers)
        return
    assert slicemaker(slices, length, workers) == want


def test_mismatched_shapes_raise():
    # tests/test_validation.py::test_mismatched_shapes_raise.
    rng = np.random.default_rng(0)
    D = rng.standard_normal((32, 16))
    bad_s = rng.standard_normal(31)
    for fn in (lambda: lasso(D, bad_s, 0.1, device="cpu"), lambda: lad(D, bad_s, device="cpu"),
               lambda: huberfit(D, bad_s, device="cpu")):
        with pytest.raises(ValueError, match="vector of length 32"):
            fn()
    with pytest.raises(ValueError, match="ell"):
        linearsvm(D, bad_s, 1.0, device="cpu")
    with pytest.raises(ValueError, match="must be 2-D"):
        lasso(rng.standard_normal(16), rng.standard_normal(16), 0.1, device="cpu")


@pytest.mark.parametrize("path", sorted(str(p.relative_to(ROOT)) for p in (
    *(ROOT / "admm_tpu_torch").rglob("*.py"), ROOT / "chip_smoke.py")))
def test_the_port_imports_neither_jax_nor_admm_tpu(path):
    tree = ast.parse((ROOT / path).read_text())
    names = [alias.name for node in ast.walk(tree) if isinstance(node, ast.Import)
             for alias in node.names]
    names += [node.module for node in ast.walk(tree)
              if isinstance(node, ast.ImportFrom) and node.level == 0 and node.module]
    assert not [n for n in names if n.split(".")[0] in ("jax", "jaxlib", "admm_tpu")]
