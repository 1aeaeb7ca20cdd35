"""Problem state carried across from ``admm_tpu`` to the port.

``admm_tpu``'s solver setups leave their operands in a ``data`` dict of
JAX arrays and solver objects.  ``numpy_state`` flattens such a dict into
plain numpy arrays (duck-typed: it never imports JAX), and ``lasso_data``,
``model_data``, ``tv_data``, ``tv2d_data``, ``fusedlasso_data``,
``program_data`` and ``matrix_data`` rebuild the port's ``data`` dicts from them on a given
device.  Feeding
the same numbers to both packages this way isolates the iteration from
differences in the setup-time linear algebra (eigh, solve, inverse),
which is what the parity tests need.

Flat keys:
- LASSO: ``D``, ``s``, ``Dts``, ``lam``; the static-rho solver, as
  ``fat.D``/``fat.E``/``fat.rho0`` (``FatShiftSolver``, fat D; ``fat.D``
  and ``fat.E`` are ``ml_dtypes.bfloat16`` arrays in the bf16-stream
  mode, carried bit for bit) or ``Minv`` (skinny D); the dynamic-rho
  solver, as ``wood.D``/``wood.V``/``wood.w`` (``WoodburySolver``, fat D)
  or ``sol.V``/``sol.w`` (``SymShiftSolver``, skinny D);
- the model problem: ``P``, ``Q``, ``r``, ``s``, ``Ptr``, ``Qts``; with
  static rho ``PtPinv``, ``QtQinv``, with dynamic rho ``solP.V``/``solP.w``
  and ``solQ.V``/``solQ.w``;
- 1-D TV: ``s``, ``lam``; ``Minv`` (dense x-update) or the
  cyclic-reduction solver as ``cr.alphas``, ``cr.betas``, ``cr.a_lv``,
  ``cr.c_lv``, ``cr.d_lv``, ``cr.masks_f``, ``cr.masks_b``, ``cr.n``,
  ``cr.cut_stride`` and, with a hybrid dense tail, ``cr.Tinv``;
- 2-D TV: ``S``, ``lam``, ``Ur``, ``wr``, ``Uc``, ``wc``;
- basis pursuit: ``P``, ``q``;
- the fused lasso: ``s``, ``t`` and ``Minv`` (static rho) or ``V``, ``w``
  (dynamic rho);
- LAD, Huber fitting and quantile regression: ``D``, ``s``, ``Dplus``
  and ``tau``; the linear SVM: ``D``, ``ell``, ``C`` and the unwrapped
  solver's ``Dplus`` (``admm_tpu``'s pinv, which its unwrappedadmm adds at
  solve time: a test puts it into the dict it flattens);
- the LP and the standard-form QP: ``b`` (LP) or ``q``, ``P``, ``r`` (QP),
  ``s`` and the KKT solver as ``kkt.*``, field by field: the Schur solve
  of dynamic rho ``kkt.D``, ``kkt.V`` (absent for the LP's identity
  basis), ``kkt.w``, ``kkt.G``; the affine fold ``kkt.K1``, ``kkt.x0``;
  or the factored apply ``kkt.Minv``, ``kkt.MinvDt``, ``kkt.D``,
  ``kkt.cf``, ``kkt.lower`` (JAX's ``cho_factor`` keeps the upper
  factor, ``lower`` False);
- the bounded QP: ``q``, ``lb``, ``ub``, ``P``, ``r`` and ``Minv``
  (static rho) or ``sol.V``/``sol.w`` (dynamic rho);
- covariance selection: ``S``, ``lam``; the SDP: ``C``, ``b`` and, for a
  dense constraint stack, ``A`` and the Gram's Cholesky factor ``L``;
- robust PCA: ``M``, ``lam``; matrix completion: ``M``, ``mask`` and
  ``mu`` (noisy form); for both, with ``prox_method='rsvd'``, the sketch's
  test matrix ``G`` (``admm_tpu`` draws it from ``PRNGKey(seed)`` inside
  the prox, so a test puts it into the dict it flattens);
- sparse logistic regression: ``D``, ``ell``, ``lam`` and, for the
  Newton-CG x-prox, ``D2``;
- optionally the warm start ``x0``, ``z0``, ``u0`` (the unwrapped
  solver's random start among them).

Matrix-free operators (TV's ``D``, 2-D TV's ``A``, the fused lasso's
``A``) hold no numbers; they are rebuilt from the shapes.
"""

from __future__ import annotations

import numpy as np
import torch

from .linop import DiffOp, StackIDiffOp
from .models.totalvariation2d import TV2DOp
from .ops.solve import (AffineKKTSolver, FatShiftSolver, StaticKKTSolver, SymShiftSolver,
                        WoodburySolver, kkt_eq_solver)
from .ops.tridiag import CyclicReductionSolver

_ARRAYS = ("D", "s", "Dts", "lam", "Minv", "S", "Ur", "wr", "Uc", "wc",
           "P", "Q", "r", "Ptr", "Qts", "PtPinv", "QtQinv", "q", "t", "V", "w",
           "Dplus", "tau", "ell", "C", "b", "lb", "ub", "A", "L", "M", "mask", "mu", "G",
           "D2")
_FAT_FIELDS = ("D", "E", "rho0")
# The solver objects carried field by field: data key -> (fields, class).
_SOLVERS = {"wood": (("D", "V", "w"), WoodburySolver),
            "sol": (("V", "w"), SymShiftSolver),
            "solP": (("V", "w"), SymShiftSolver),
            "solQ": (("V", "w"), SymShiftSolver)}
# The three KKT solvers behind data["kkt"], told apart by a field only
# each has: (fields, class); the Schur solve's V is None for the LP.
_KKT = {"G": (("D", "V", "w", "G"), kkt_eq_solver),
        "K1": (("K1", "x0"), AffineKKTSolver),
        "cf": (("Minv", "MinvDt", "D", "cf", "lower"), StaticKKTSolver)}
_CR_STACKS = ("alphas", "betas", "a_lv", "c_lv", "d_lv")
_CR_MASKS = ("masks_f", "masks_b")


def numpy_state(data: dict, **warm) -> dict:
    """Flatten the ``data`` dict of a ported family (from either package)
    plus optional ``x0``/``z0``/``u0`` arrays into ``{flat key: numpy
    array}``."""
    state = {}
    for key, val in data.items():
        if key == "fat":
            state.update({f"fat.{f}": _np(getattr(val, f)) for f in _FAT_FIELDS})
        elif key == "kkt":
            fields = next(f for k, (f, _) in _KKT.items() if hasattr(val, k))
            state.update({f"kkt.{f}": _np(getattr(val, f)) for f in fields
                          if getattr(val, f) is not None})
        elif key in _SOLVERS:
            state.update({f"{key}.{f}": _np(getattr(val, f)) for f in _SOLVERS[key][0]})
        elif key == "cr":
            if not hasattr(val, "masks_f"):
                raise ValueError(
                    "numpy_state: only the masked cyclic-reduction solver is "
                    f"carried across, not {type(val).__name__}")
            state.update({f"cr.{f}": _np(getattr(val, f))
                          for f in _CR_STACKS + _CR_MASKS})
            state["cr.n"] = np.array(val.n)
            state["cr.cut_stride"] = np.array(val.cut_stride)
            if val.Tinv is not None:
                state["cr.Tinv"] = _np(val.Tinv)
        elif hasattr(val, "mv") and hasattr(val, "rmv"):
            continue  # a matrix-free operator: rebuilt from the shapes
        elif key in _ARRAYS:
            state[key] = _np(val)
        else:
            raise ValueError(
                f"numpy_state: no conversion for data[{key!r}]; only the "
                "state of the ported families is carried across")
    state.update({k: _np(v) for k, v in warm.items() if v is not None})
    return state


def _maker(state, lead, device, dtype):
    """``(t, warm)``: ``t(key)`` puts ``state[key]`` on ``device`` in
    ``dtype`` (default: the dtype of ``state[lead]``), bf16 arrays (the
    bf16-stream ``fat.D``/``fat.E``) in bf16 bit for bit; ``warm`` holds
    the warm-start tensors present in the state."""
    device = torch.device(device)
    if dtype is None:
        dtype = torch.from_numpy(np.zeros(0, state[lead].dtype)).dtype

    def t(key, dt=dtype):
        arr = state[key]
        if arr.dtype.name == "bfloat16":  # ml_dtypes: torch takes its bits
            bits = np.ascontiguousarray(arr).view(np.uint16)
            return torch.from_numpy(bits).view(torch.bfloat16).to(device)
        return torch.tensor(arr, dtype=dt, device=device)

    return t, {k: t(k) for k in ("x0", "z0", "u0") if k in state}


def lasso_data(state: dict, *, device="cpu", dtype=None):
    """Build ``(data, warm)`` for the port from a flat numpy ``state``:
    ``data`` is the dict the port's proxes take and ``warm`` holds the
    warm-start tensors ``x0``/``z0``/``u0`` present in the state.  It
    serves every family whose state D leads: LASSO and its siblings, LAD,
    Huber, quantile and the linear SVM with their ``Dplus``, and sparse
    logistic regression.  Every
    tensor lands on ``device`` in ``dtype`` (default: D's dtype), except
    bf16 stream arrays, which stay bf16."""
    return _data(state, "D", device, dtype)


def model_data(state: dict, *, device="cpu", dtype=None):
    """``(data, warm)`` for the port's model-problem proxes
    (``models/model.py``) and basis pursuit's (``P``, ``q``), as
    ``lasso_data`` builds them for LASSO; the default dtype is P's."""
    return _data(state, "P", device, dtype)


def _data(state, lead, device, dtype):
    """The arrays and solver objects present in ``state`` as the port's
    ``data`` dict, and the warm start; the default dtype is that of
    ``state[lead]``."""
    t, warm = _maker(state, lead, device, dtype)
    data = {k: t(k) for k in _ARRAYS if k in state}
    if "fat.E" in state:
        data["fat"] = FatShiftSolver(*(t(f"fat.{f}") for f in _FAT_FIELDS))
    data.update(_solvers(state, t))
    for mark, (fields, cls) in _KKT.items():
        if f"kkt.{mark}" in state:
            data["kkt"] = cls(*(bool(state["kkt.lower"]) if f == "lower"
                                else t(f"kkt.{f}") if f"kkt.{f}" in state else None
                                for f in fields))
    return data, warm


def _solvers(state, t):
    """The solver objects of ``_SOLVERS`` present in ``state``, rebuilt
    from their fields with ``t``."""
    return {key: cls(*(t(f"{key}.{f}") for f in fields))
            for key, (fields, cls) in _SOLVERS.items() if f"{key}.{fields[-1]}" in state}


def program_data(state: dict, *, device="cpu", dtype=None):
    """``(data, warm)`` for the port's LP, QP, covariance-selection and SDP
    proxes (``models/linearprogram.py``, ``quadraticprogram.py``,
    ``covarianceselection.py``, ``sdp.py``): the arrays, ``Minv`` or
    ``sol`` of the bounded QP, and the KKT solver rebuilt from its
    ``kkt.*`` fields.  The default dtype is that of the first of P, S, C,
    b in the state."""
    return _data(state, next(k for k in ("P", "S", "C", "b") if k in state), device, dtype)


def matrix_data(state: dict, *, device="cpu", dtype=None):
    """``(data, warm)`` for the port's robust-PCA and matrix-completion
    proxes (``models/rpca.py``, ``models/matrixcompletion.py``): ``M``,
    ``lam`` or ``mask``/``mu``, and the sketch's ``G``; the default dtype
    is M's."""
    return _data(state, "M", device, dtype)


def tv_data(state: dict, *, device="cpu", dtype=None):
    """``(data, warm)`` for the port's 1-D TV proxes
    (``models/totalvariation.py``), as ``lasso_data`` builds them for
    LASSO; the default dtype is s's."""
    t, warm = _maker(state, "s", device, dtype)
    data = {"s": t("s"), "lam": t("lam"), "D": DiffOp(state["s"].shape[0])}
    if "Minv" in state:
        data["Minv"] = t("Minv")
    if "cr.alphas" in state:
        data["cr"] = CyclicReductionSolver(
            *(t(f"cr.{f}") for f in _CR_STACKS),
            *(t(f"cr.{f}", torch.bool) for f in _CR_MASKS),
            int(state["cr.n"]),
            Tinv=t("cr.Tinv") if "cr.Tinv" in state else None,
            cut_stride=int(state["cr.cut_stride"]))
    return data, warm


def tv2d_data(state: dict, *, device="cpu", dtype=None):
    """``(data, warm)`` for the port's 2-D TV proxes
    (``models/totalvariation2d.py``); the default dtype is S's."""
    t, warm = _maker(state, "S", device, dtype)
    data = {k: t(k) for k in ("S", "lam", "Ur", "wr", "Uc", "wc")}
    data["A"] = TV2DOp(*state["S"].shape)
    return data, warm


def fusedlasso_data(state: dict, *, device="cpu", dtype=None):
    """``(data, warm)`` for the port's fused-lasso proxes
    (``models/fusedlasso.py``): ``s``, the threshold vector ``t``, ``Minv``
    or ``V``/``w``, and the matrix-free ``A`` rebuilt from s's length; the
    default dtype is s's."""
    data, warm = _data(state, "s", device, dtype)
    data["A"] = StackIDiffOp(state["s"].shape[0])
    return data, warm


def _np(v):
    if isinstance(v, torch.Tensor):
        v = v.detach().cpu()
        if v.dtype == torch.bfloat16:  # numpy has no bf16: ml_dtypes's, by its bits
            import ml_dtypes

            return v.view(torch.int16).numpy().view(ml_dtypes.bfloat16)
        return v.numpy()
    return np.array(v)
