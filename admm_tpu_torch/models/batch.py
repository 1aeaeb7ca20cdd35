"""Instance-batched solvers (port of ``admm_tpu/models/batch.py``): B
independent problem instances as the lanes of one solve.

Where a path (``paths.py``) sweeps a hyperparameter on one instance, here
the data varies per lane and every factorization that does not depend on
it is shared: ``lasso_batch`` codes a batch of signals against one
dictionary (the per-lane x-update GEMVs become one (B, m) x (m, n) GEMM),
``tv_batch`` denoises a batch of 1-D signals (the cyclic-reduction solve
of all lanes is one launch of K4 a sub-step), ``lad_batch``,
``huberfit_batch`` and ``quantile_batch`` fit many right-hand sides
against one design, ``svm_batch`` and ``logreg_batch`` train one-vs-all
classifiers, ``lp_batch`` and ``qp_batch`` solve the MPC pattern (one KKT
fold shared, the offsets one setup GEMM), and every other family has its
batched variant.

The lanes run through ``engine.make_admm_runner(lanes=True)``: the step
under ``torch.func.vmap``, each lane frozen once it is done, one host read
a chunk.  ``steps``, ``objopt``, ``rho_final``, the ``stalled`` flags and
every history are per lane.  ``mesh=`` (a 1-D ``parallel.make_mesh``)
divides the lanes over the mesh, with ``admm_tpu``'s checks: on a stacked
mesh every lane runs on its one device, as without a mesh, bit for bit;
over a process group each rank runs its block of lanes with no collective
inside the loop, and the results come back whole through one
``all_gather``.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch

from ..config import ADMMConfig
from ..device import resolve_device
from torch.utils import _pytree as pytree

from ._common import as_tensor, merge_config
from .paths import highest_precision_setup, shard_lanes, solve_lanes


@dataclasses.dataclass
class BatchResults:
    """Stacked per-lane results: leading axis = instance index."""

    xopt: Any
    zopt: Any
    uopt: Any
    steps: Any       # (B,) iterations per instance
    objopt: Any = None  # (B,) per-instance objective at the solution
    rho_final: Any = None  # (B,) final rho per lane (rbadaptive/adaptive)
    runtime: float = 0.0
    hist: dict = dataclasses.field(default_factory=dict)
    # Solver-specific extras: the (B,) plateau flags ``stalled``.
    extra: dict = dataclasses.field(default_factory=dict)


def _ndim(v):
    return v.ndim if hasattr(v, "ndim") else np.ndim(v)


def _on(v, device, dtype):
    return as_tensor(v).to(device=device, dtype=dtype)


def _check_batch(S, m, what):
    if S.ndim != 2 or S.shape[1] != m:
        raise ValueError(
            f"{what} must be a (B, {m}) batch of row instances, got {tuple(S.shape)}")
    return S


def _broadcast_lane(v, Bn, shape1, dtype, what, device):
    """Coerce ``v`` to a (Bn, *shape1) per-lane stack (broadcasting a
    shared one-instance value across the lanes)."""
    v = _on(v, device, dtype)
    if tuple(v.shape) == tuple(shape1):
        return v.expand((Bn, *shape1)).contiguous()
    if tuple(v.shape) == (Bn, *shape1):
        return v
    raise ValueError(
        f"{what} must have shape {tuple(shape1)} (shared) or "
        f"{(Bn, *shape1)} (per-lane), got {tuple(v.shape)}")


def _lane_count(*cands):
    """The batch size of the first stacked candidate: each entry is
    (value, instance ndim)."""
    for v, nd1 in cands:
        if _ndim(v) == nd1 + 1:
            return int(v.shape[0]) if hasattr(v, "shape") else len(v)
    raise ValueError(
        "at least one argument must carry a leading batch axis "
        "(all inputs are single-instance; use the serial solver)")


def _lanes(v, Bn, dtype, device):
    """A scalar or (Bn,) per-lane value as a (Bn,) tensor."""
    return _on(v, device, dtype).expand(Bn).contiguous()


def _run(prox_f, prox_g, obj, config, mapped, data, x0, z0, u0, c0, A, B,
         mesh=None, warm=None) -> BatchResults:
    if warm is not None:
        # Warm start (receding-horizon re-solves: seed from the previous
        # BatchResults).  Each entry may be None (keep the solver's
        # default), one instance (broadcast), or a (B, ...) stack.
        x0, z0, u0 = (
            d if w is None else _broadcast_lane(w, d.shape[0], d.shape[1:], d.dtype, name,
                                                d.device)
            for w, d, name in zip(warm, (x0, z0, u0), ("x0", "z0", "u0")))
    rows = shard_lanes(mesh, x0.shape[0], x0.device)
    if rows is not None:
        data = {k: pytree.tree_map(lambda v: v[rows], v) if k in mapped else v
                for k, v in data.items()}
        x0, z0, u0, c0 = (v[rows] for v in (x0, z0, u0, c0))
    out, runtime = solve_lanes(prox_f, prox_g, obj, config, mapped, data, x0, z0, u0, c0,
                               A, B)
    if mesh is not None:
        from ..parallel._loop import gather_tree

        out = gather_tree(mesh, out)
    return BatchResults(
        xopt=out["xopt"], zopt=out["zopt"], uopt=out["uopt"], steps=out["steps"],
        objopt=out["objopt"], rho_final=out["rho_final"], runtime=runtime,
        hist=out["hist"], extra={"stalled": out["stalled"]})


def _ls_lanes(D, S, device):
    """The shared D and the (B, m) right-hand sides of a least-squares
    family, on the solve's device."""
    device = resolve_device(device, D, S)
    D = as_tensor(D).to(device)
    S = _check_batch(_on(S, device, D.dtype), D.shape[0], "S")
    return D, S, device


@highest_precision_setup
def lasso_batch(D, S, lams, config: ADMMConfig = ADMMConfig(), *, stream_dtype=None,
                x0=None, z0=None, u0=None, mesh=None, device=None,
                **overrides) -> BatchResults:
    """Solve LASSO for every signal row of ``S`` (shape (B, m)) against the
    shared dictionary ``D`` (shape (m, n)) as lanes of one solve.

    ``lams`` is a scalar (shared) or a (B,) vector.  The x-update's
    factorization depends only on (D, rho) and is shared; only s, D^T s
    and lam are per lane.  ``stream_dtype=torch.bfloat16`` stores the fat
    branch's two stream matrices in bf16, as in ``lasso``: the lanes'
    products upcast the streams to f32 and keep f32 outputs (K2 is a
    one-lane kernel).  The solve runs on ``device``, or on D's device when
    D is a tensor, or on the CUDA device (``device.resolve_device``)."""
    from .lasso import make_prox_ops

    config = merge_config(config, overrides, body="batched")
    D, S, device = _ls_lanes(D, S, device)
    Bn, n = S.shape[0], D.shape[1]
    prox_f, prox_g, obj, data = make_prox_ops(D, S[0], 1.0, config, stream_dtype)
    data = dict(data, s=S, Dts=S @ D, lam=_lanes(lams, Bn, D.dtype, device))
    zeros = D.new_zeros((Bn, n))
    return _run(prox_f, prox_g, obj, config, {"s", "Dts", "lam"}, data,
                zeros, zeros, zeros, zeros, 1.0, -1.0, mesh=mesh, warm=(x0, z0, u0))


@highest_precision_setup
def elasticnet_batch(D, S, lams, alphas=0.5, config: ADMMConfig = ADMMConfig(), *,
                     stream_dtype=None, x0=None, z0=None, u0=None, mesh=None, device=None,
                     **overrides) -> BatchResults:
    """Elastic net for every signal row of ``S`` (B, m) against the shared
    ``D``; ``lams``/``alphas`` are scalars or (B,) vectors."""
    from .elasticnet import _obj, _prox_g
    from .lasso import make_ls_xprox

    config = merge_config(config, overrides, body="batched")
    a = np.asarray(as_tensor(alphas).cpu(), float)
    if np.any(a < 0) or np.any(a > 1):
        raise ValueError(f"alpha must be in [0, 1], got {alphas}")
    D, S, device = _ls_lanes(D, S, device)
    Bn, n = S.shape[0], D.shape[1]
    prox_f, data = make_ls_xprox(D, S[0], config, stream_dtype)
    data.update(s=S, Dts=S @ D, lam=_lanes(lams, Bn, D.dtype, device),
                alpha=_lanes(alphas, Bn, D.dtype, device))
    zeros = D.new_zeros((Bn, n))
    return _run(prox_f, _prox_g, _obj, config, {"s", "Dts", "lam", "alpha"}, data,
                zeros, zeros, zeros, zeros, 1.0, -1.0, mesh=mesh, warm=(x0, z0, u0))


@highest_precision_setup
def grouplasso_batch(D, S, lams, groups, weights=None, config: ADMMConfig = ADMMConfig(), *,
                     stream_dtype=None, x0=None, z0=None, u0=None, mesh=None, device=None,
                     **overrides) -> BatchResults:
    """Group lasso for every signal row of ``S`` (B, m); the group
    structure (and optional per-group weights) is shared, ``lams`` is a
    scalar or (B,) vector."""
    from .grouplasso import make_prox_ops

    config = merge_config(config, overrides, body="batched")
    D, S, device = _ls_lanes(D, S, device)
    Bn, n = S.shape[0], D.shape[1]
    prox_f, _prox_g, _obj, data = make_prox_ops(D, S[0], 1.0, groups, weights, config,
                                                stream_dtype)
    data.update(s=S, Dts=S @ D, lam=_lanes(lams, Bn, D.dtype, device))
    zeros = D.new_zeros((Bn, n))
    return _run(prox_f, _prox_g, _obj, config, {"s", "Dts", "lam"}, data,
                zeros, zeros, zeros, zeros, 1.0, -1.0, mesh=mesh, warm=(x0, z0, u0))


@highest_precision_setup
def nnls_batch(D, S, config: ADMMConfig = ADMMConfig(), *, stream_dtype=None,
               x0=None, z0=None, u0=None, mesh=None, device=None, **overrides) -> BatchResults:
    """Nonnegative least squares for every row of ``S`` (B, m) against the
    shared ``D``: one shared factorization, a projection z-update per
    lane."""
    from .lasso import make_ls_xprox
    from .nnls import _obj, _prox_g

    config = merge_config(config, overrides, body="batched")
    D, S, device = _ls_lanes(D, S, device)
    Bn, n = S.shape[0], D.shape[1]
    prox_f, data = make_ls_xprox(D, S[0], config, stream_dtype)
    data.update(s=S, Dts=S @ D)
    zeros = D.new_zeros((Bn, n))
    return _run(prox_f, _prox_g, _obj, config, {"s", "Dts"}, data,
                zeros, zeros, zeros, zeros, 1.0, -1.0, mesh=mesh, warm=(x0, z0, u0))


@highest_precision_setup
def basispursuit_batch(D, S, config: ADMMConfig = ADMMConfig(), *, x0=None, z0=None,
                       u0=None, mesh=None, device=None, **overrides) -> BatchResults:
    """Basis pursuit for every measurement row of ``S`` (B, m) against the
    shared underdetermined ``D`` (m, n): the projection
    P = I - D^T (D D^T)^{-1} D is shared, only the offset
    q = D^T (D D^T)^{-1} s is per lane (all lanes in one GEMM)."""
    from .basispursuit import _obj, _prox_f, _prox_g

    config = merge_config(config, overrides, body="batched")
    device = resolve_device(device, D, S)
    D = as_tensor(D).to(device)
    m, n = D.shape
    if m >= n:
        raise ValueError(
            "basis pursuit requires an underdetermined system (m < n); "
            f"got D of shape {(m, n)} (reference basispursuit.m:192-203)")
    S = _check_batch(_on(S, device, D.dtype), m, "S")
    Bn = S.shape[0]
    G = D @ D.T
    GinvD = torch.cholesky_solve(D, torch.linalg.cholesky(0.5 * (G + G.T)))
    data = {"P": torch.eye(n, dtype=D.dtype, device=device) - D.T @ GinvD, "q": S @ GinvD}
    zeros = D.new_zeros((Bn, n))
    return _run(_prox_f, _prox_g, _obj, config, {"q"}, data,
                zeros, zeros, zeros, zeros, 1.0, -1.0, mesh=mesh, warm=(x0, z0, u0))


@highest_precision_setup
def tv_batch(S, lams, config: ADMMConfig = ADMMConfig(), *, solver: str = "auto",
             x0=None, z0=None, u0=None, mesh=None, device=None, _plain_cr=False,
             **overrides) -> BatchResults:
    """1-D TV denoising of every signal row of ``S`` (B, n) as lanes of one
    solve.

    The (I + rho D^T D) solve is signal-free and shared; ``lams`` is a
    scalar or (B,) vector.  A cyclic-reduction solver takes the hybrid
    form (cutoff 1023), as ``admm_tpu``'s batched TV does, and on a CUDA
    device the lanes' solves of a sub-step are one launch of K4 on
    (B, n).  ``_plain_cr`` is for tests only: the b-phase through the plain
    PyTorch version on any device (``totalvariation(_plain_cr=True)``)."""
    from .totalvariation import _prox_f_cr, _prox_f_cr_plain, make_prox_ops

    config = merge_config(config, overrides, body="batched")
    device = resolve_device(device, S)
    S = as_tensor(S).to(device)
    if S.ndim != 2:
        raise ValueError(f"S must be a (B, n) batch of signals, got {tuple(S.shape)}")
    Bn, n = S.shape
    prox_f, prox_g, obj, data, Dop = make_prox_ops(S[0], 1.0, config, solver, batched=True)
    if _plain_cr:
        if prox_f is not _prox_f_cr:
            raise ValueError("_plain_cr needs a cyclic-reduction solver")
        prox_f = _prox_f_cr_plain
    data = dict(data, s=S, lam=_lanes(lams, Bn, S.dtype, device))
    zeros = S.new_zeros((Bn, n))
    return _run(prox_f, prox_g, obj, config, {"s", "lam"}, data,
                zeros, zeros, zeros, zeros, Dop, -1.0, mesh=mesh, warm=(x0, z0, u0))


def _square_stack(Ms, what, device):
    Ms = as_tensor(Ms).to(device)
    if Ms.ndim != 3 or Ms.shape[1] != Ms.shape[2]:
        raise ValueError(f"{what}, got {tuple(Ms.shape)}")
    return Ms


@highest_precision_setup
def covsel_batch(Ss, lams, config: ADMMConfig = ADMMConfig(), *, prox_method: str = "ns",
                 ns_iters: int = 20, ns_coarse: int = 0, ns_correct: int = 0,
                 x0=None, z0=None, u0=None, mesh=None, device=None,
                 **overrides) -> BatchResults:
    """Graphical lasso for every covariance matrix in ``Ss`` (B, n, n) as
    lanes of one solve (build each lane's covariance with
    ``covarianceselection.empirical_covariance``).  The default x-prox is
    Newton-Schulz (batched GEMMs, nothing read back); ``'eigh'`` batches
    the eigendecompositions, one host read a sub-step; ``'ns_fast'`` as in
    ``covarianceselection``.  ``lams`` is a scalar or (B,) vector."""
    from .covarianceselection import make_prox_ops

    config = merge_config(config, overrides, body="batched")
    device = resolve_device(device, Ss)
    Ss = _square_stack(Ss, "Ss must be a (B, n, n) stack of covariance matrices", device)
    Bn, n = Ss.shape[0], Ss.shape[1]
    prox_f, prox_g, obj, data = make_prox_ops(Ss[0], 1.0, config, prox_method=prox_method,
                                              ns_iters=ns_iters, ns_coarse=ns_coarse,
                                              ns_correct=ns_correct)
    data = dict(data, S=Ss, lam=_lanes(lams, Bn, Ss.dtype, device))
    zeros = Ss.new_zeros((Bn, n, n))
    return _run(prox_f, prox_g, obj, config, {"S", "lam"}, data,
                zeros, zeros, zeros, zeros, 1.0, -1.0, mesh=mesh, warm=(x0, z0, u0))


@highest_precision_setup
def sdp_batch(Cs, A, bs, config: ADMMConfig = ADMMConfig(), *, prox_method: str = "eigh",
              ns_iters: int = 24, ns_coarse: int = 0, ns_correct: int = 0,
              ns_delta: float = 0.0, x0=None, z0=None, u0=None, mesh=None, device=None,
              **overrides) -> BatchResults:
    """Standard-form SDP for every cost matrix in ``Cs`` (B, n, n) against
    a shared constraint operator ``A`` (an (m, n, n) stack or ``'diag'``)
    as lanes of one solve, e.g. max-cut relaxations over a batch of
    graphs.  ``bs`` is (m,) shared or (B, m); the Gram factorization of A
    is shared, only (C, b) are per lane."""
    from .sdp import _sym, make_prox_ops

    config = merge_config(config, overrides, body="batched")
    device = resolve_device(device, Cs, bs)
    Cs = as_tensor(Cs).to(device)
    if Cs.ndim != 3 or Cs.shape[1] != Cs.shape[2]:
        raise ValueError(f"Cs must be a (B, n, n) stack, got {tuple(Cs.shape)}")
    Bn, n = Cs.shape[0], Cs.shape[1]
    bs = _on(bs, device, Cs.dtype)
    m = bs.shape[-1]
    prox_f, prox_g, obj, data = make_prox_ops(
        Cs[0], A, bs if bs.ndim == 1 else bs[0], config, prox_method=prox_method,
        ns_iters=ns_iters, ns_coarse=ns_coarse, ns_correct=ns_correct, ns_delta=ns_delta,
        device=device)
    data = dict(data, C=_sym(Cs), b=bs.expand(Bn, m).contiguous())
    zeros = Cs.new_zeros((Bn, n, n))
    return _run(prox_f, prox_g, obj, config, {"C", "b"}, data,
                zeros, zeros, zeros, zeros, 1.0, -1.0, mesh=mesh, warm=(x0, z0, u0))


@highest_precision_setup
def fusedlasso_batch(S, lam1s, lam2s, config: ADMMConfig = ADMMConfig(), *, x0=None,
                     z0=None, u0=None, mesh=None, device=None, **overrides) -> BatchResults:
    """Fused lasso for every signal row of ``S`` (B, n) as lanes of one
    solve: the eig-folded x-solve is shared, each lane carries its signal
    and its (lam1, lam2) pair in the stacked threshold vector t (B, 2n)."""
    from .fusedlasso import make_prox_ops

    config = merge_config(config, overrides, body="batched")
    device = resolve_device(device, S)
    S = as_tensor(S).to(device)
    if S.ndim != 2:
        raise ValueError(f"S must be a (B, n) stack of signals, got {tuple(S.shape)}")
    Bn, n = S.shape
    prox_f, prox_g, obj, data, Aop = make_prox_ops(S[0], 1.0, 1.0, config)
    l1, l2 = (_lanes(v, Bn, S.dtype, device) for v in (lam1s, lam2s))
    t = torch.cat((l1[:, None].expand(Bn, n), l2[:, None].expand(Bn, n)), dim=1)
    data = dict(data, s=S, t=t)
    xz, zz = S.new_zeros((Bn, n)), S.new_zeros((Bn, 2 * n))
    return _run(prox_f, prox_g, obj, config, {"s", "t"}, data,
                xz, zz, zz, zz, Aop, -1.0, mesh=mesh, warm=(x0, z0, u0))


def _matrix_stack(Ms, device):
    Ms = as_tensor(Ms).to(device)
    if Ms.ndim != 3:
        raise ValueError(f"Ms must be a (B, m, n) stack, got {tuple(Ms.shape)}")
    return Ms


@highest_precision_setup
def rpca_batch(Ms, lams=None, config: ADMMConfig = ADMMConfig(), *,
               prox_method: str = "exact", rank=None, oversample: int = 10,
               power_iters: int = 2, seed: int = 0, x0=None, z0=None, u0=None, mesh=None,
               device=None, **overrides) -> BatchResults:
    """Robust PCA for every matrix in ``Ms`` (B, m, n) as lanes of one
    solve, e.g. per-frame background/foreground separation.  The SVT
    L-step is one batched SVD a sub-step (one host read), or at
    ``prox_method='rsvd'`` with a ``rank`` bound the randomized sketch
    (its G shared by the lanes).  ``lams`` is a scalar or (B,) vector
    (default: 1/sqrt(max(m, n)))."""
    from .rpca import make_prox_ops

    config = merge_config(config, overrides, body="batched")
    device = resolve_device(device, Ms)
    Ms = _matrix_stack(Ms, device)
    Bn, m, n = Ms.shape
    lam0 = None if lams is None else as_tensor(lams).reshape(-1)[0]
    prox_f, prox_g, obj, data = make_prox_ops(
        Ms[0], lam0, config, prox_method=prox_method, rank=rank, oversample=oversample,
        power_iters=power_iters, seed=seed)
    lam = data["lam"] if lams is None else lams
    data = dict(data, M=Ms, lam=_lanes(lam, Bn, Ms.dtype, device))
    zeros = Ms.new_zeros((Bn, m, n))
    return _run(prox_f, prox_g, obj, config, {"M", "lam"}, data,
                zeros, zeros, zeros, Ms, 1.0, 1.0, mesh=mesh, warm=(x0, z0, u0))


@highest_precision_setup
def matrixcompletion_batch(Ms, masks, mu=None, config: ADMMConfig = ADMMConfig(), *,
                           prox_method: str = "exact", rank=None, oversample: int = 10,
                           power_iters: int = 2, seed: int = 0, x0=None, z0=None, u0=None,
                           mesh=None, device=None, **overrides) -> BatchResults:
    """Nuclear-norm matrix completion for every (M, mask) pair of the
    (B, m, n) stacks as lanes of one solve.  ``mu`` is None (exact
    constraint), a scalar or a (B,) per-lane fit weight.  The completed
    matrices are ``zopt``."""
    from .matrixcompletion import make_prox_ops

    config = merge_config(config, overrides, body="batched")
    device = resolve_device(device, Ms, masks)
    Ms = _matrix_stack(Ms, device)
    masks = _on(masks, device, Ms.dtype)
    if tuple(masks.shape) != tuple(Ms.shape):
        raise ValueError(
            f"masks must match Ms's shape {tuple(Ms.shape)}, got {tuple(masks.shape)}")
    Bn, m, n = Ms.shape
    mu0 = None if mu is None else as_tensor(mu).reshape(-1)[0]
    prox_f, prox_g, obj, data = make_prox_ops(
        Ms[0], masks[0], mu0, config, prox_method=prox_method, rank=rank,
        oversample=oversample, power_iters=power_iters, seed=seed)
    data = dict(data, M=Ms * masks, mask=masks)
    mapped = {"M", "mask"}
    if mu is not None:
        data["mu"] = _lanes(mu, Bn, Ms.dtype, device)
        mapped.add("mu")
    zeros = Ms.new_zeros((Bn, m, n))
    return _run(prox_f, prox_g, obj, config, mapped, data,
                zeros, zeros, zeros, zeros, 1.0, -1.0, mesh=mesh, warm=(x0, z0, u0))


@highest_precision_setup
def model_batch(P, Q, Rs, Ss, config: ADMMConfig = ADMMConfig(), *, x0=None, z0=None,
                u0=None, mesh=None, device=None, **overrides) -> BatchResults:
    """The model problem  min 1/2||P x - r_i||^2 + 1/2||Q x - s_i||^2  for
    every right-hand-side pair against the shared ``P`` (mP, n) and ``Q``
    (mQ, n).  ``Rs`` is (mP,) shared or (B, mP), ``Ss`` (mQ,) or (B, mQ),
    at least one stacked; both regularized inverses are shared."""
    from .model import make_prox_ops

    config = merge_config(config, overrides, body="batched")
    device = resolve_device(device, P, Q, Rs, Ss)
    P = as_tensor(P).to(device)
    Q = _on(Q, device, P.dtype)
    n = P.shape[1]
    Bn = _lane_count((Rs, 1), (Ss, 1))
    Rs = _broadcast_lane(Rs, Bn, (P.shape[0],), P.dtype, "Rs", device)
    Ss = _broadcast_lane(Ss, Bn, (Q.shape[0],), P.dtype, "Ss", device)
    prox_f, prox_g, obj, data = make_prox_ops(P, Q, Rs[0], Ss[0], config)
    data = dict(data, r=Rs, s=Ss, Ptr=Rs @ P, Qts=Ss @ Q)
    zeros = P.new_zeros((Bn, n))
    return _run(prox_f, prox_g, obj, config, {"r", "s", "Ptr", "Qts"}, data,
                zeros, zeros, zeros, zeros, 1.0, -1.0, mesh=mesh, warm=(x0, z0, u0))


@highest_precision_setup
def tv2d_batch(Ss, lams, config: ADMMConfig = ADMMConfig(), *, x0=None, z0=None, u0=None,
               mesh=None, device=None, **overrides) -> BatchResults:
    """Anisotropic 2-D TV denoising of every image in ``Ss`` (B, m, n) as
    lanes of one solve; the two 1-D difference eigenbases are shared, the
    image and its ``lams`` (scalar or (B,)) are per lane."""
    from .totalvariation2d import make_prox_ops

    config = merge_config(config, overrides, body="batched")
    device = resolve_device(device, Ss)
    Ss = as_tensor(Ss).to(device)
    if Ss.ndim != 3:
        raise ValueError(f"Ss must be a (B, m, n) stack of images, got {tuple(Ss.shape)}")
    Bn, m, n = Ss.shape
    prox_f, prox_g, obj, data, Aop = make_prox_ops(Ss[0], 1.0, config)
    data = dict(data, S=Ss, lam=_lanes(lams, Bn, Ss.dtype, device))
    zx, zz = Ss.new_zeros((Bn, m, n)), Ss.new_zeros((Bn, 2, m, n))
    return _run(prox_f, prox_g, obj, config, {"S", "lam"}, data,
                zx, zz, zz, zz, Aop, -1.0, mesh=mesh, warm=(x0, z0, u0))


def _rhs_batch(make_prox_ops, D, S, config, device):
    """Shared LAD/Huber multi-RHS setup: one normal-equations
    pseudo-inverse, per-lane right-hand sides (the constraint offset
    c = s is per lane through the runner's c)."""
    D, S, device = _ls_lanes(D, S, device)
    m, n = D.shape
    prox_f, prox_g, obj, data = make_prox_ops(D, S[0], config)
    data = dict(data, s=S)
    Bn = S.shape[0]
    return prox_f, prox_g, obj, data, D, D.new_zeros((Bn, n)), D.new_zeros((Bn, m)), S


@highest_precision_setup
def lad_batch(D, S, config: ADMMConfig = ADMMConfig(), *, x0=None, z0=None, u0=None,
              mesh=None, device=None, **overrides) -> BatchResults:
    """Least absolute deviations for every right-hand side row of ``S``
    (B, m) against the shared design ``D`` (m, n)."""
    from .lad import make_prox_ops

    config = merge_config(config, overrides, body="batched")
    prox_f, prox_g, obj, data, D, xz, zz, S = _rhs_batch(make_prox_ops, D, S, config, device)
    return _run(prox_f, prox_g, obj, config, {"s"}, data, xz, zz, zz, S, D, -1.0,
                mesh=mesh, warm=(x0, z0, u0))


@highest_precision_setup
def huberfit_batch(D, S, config: ADMMConfig = ADMMConfig(), *, x0=None, z0=None, u0=None,
                   mesh=None, device=None, **overrides) -> BatchResults:
    """Huber fitting for every right-hand side row of ``S`` (B, m) against
    the shared design ``D`` (m, n)."""
    from .huberfit import make_prox_ops

    config = merge_config(config, overrides, body="batched")
    prox_f, prox_g, obj, data, D, xz, zz, S = _rhs_batch(make_prox_ops, D, S, config, device)
    return _run(prox_f, prox_g, obj, config, {"s"}, data, xz, zz, zz, S, D, -1.0,
                mesh=mesh, warm=(x0, z0, u0))


@highest_precision_setup
def quantile_batch(D, S, taus, config: ADMMConfig = ADMMConfig(), *, x0=None, z0=None,
                   u0=None, mesh=None, device=None, **overrides) -> BatchResults:
    """Quantile regression lanes against the shared design ``D`` (m, n):
    each lane has its right-hand side (``S`` (B, m), or one (m,) vector
    broadcast) and its quantile level (``taus`` scalar or (B,)), e.g. a
    tau grid over one dataset, sharing one factorization."""
    from .quantile import make_prox_ops

    config = merge_config(config, overrides, body="batched")
    device = resolve_device(device, D, S)
    D = as_tensor(D).to(device)
    m, n = D.shape
    Bn = _lane_count((S, 1), (taus, 0))
    S = _broadcast_lane(S, Bn, (m,), D.dtype, "S", device)
    taus = _lanes(taus, Bn, D.dtype, device)
    if not bool(torch.all((taus > 0) & (taus < 1))):
        raise ValueError("every tau must be in (0, 1)")
    prox_f, prox_g, obj, data = make_prox_ops(D, S[0], float(taus[0]), config)
    data = dict(data, s=S, tau=taus)
    return _run(prox_f, prox_g, obj, config, {"s", "tau"}, data,
                D.new_zeros((Bn, n)), D.new_zeros((Bn, m)), D.new_zeros((Bn, m)), S, D, -1.0,
                mesh=mesh, warm=(x0, z0, u0))


@highest_precision_setup
def logreg_batch(D, ells, lams, config: ADMMConfig = ADMMConfig(), *,
                 inner: str = "newton_cg", newton_steps: int = 4, cg_steps: int = 12,
                 x0=None, z0=None, u0=None, mesh=None, device=None,
                 **overrides) -> BatchResults:
    """B sparse logistic regressions against one shared data matrix: one-vs-
    all multiclass training as lanes of one solve.  ``ells`` is (B, m)
    lanes of +/-1 labels, ``lams`` a scalar or (B,) l1 weights.  The
    default x-prox is the matrix-free Newton-CG (its matvecs batch into
    (B, m) x (m, n) GEMMs); ``inner='newton'`` solves (B, n, n) Hessians
    by Cholesky (``cholesky_ex``, no host read)."""
    from .logreg import make_prox_ops

    config = merge_config(config, overrides, body="batched")
    device = resolve_device(device, D, ells)
    D = as_tensor(D).to(device)
    m, n = D.shape
    ells = _check_batch(_on(ells, device, D.dtype), m, "ells")
    if not bool(torch.all(torch.abs(ells) == 1.0)):
        raise ValueError("ells must be +/-1 label lanes")
    Bn = ells.shape[0]
    prox_f, prox_g, obj, data = make_prox_ops(D, ells[0], 1.0, config, inner=inner,
                                              newton_steps=newton_steps, cg_steps=cg_steps)
    data = dict(data, ell=ells, lam=_lanes(lams, Bn, D.dtype, device))
    zeros = D.new_zeros((Bn, n))
    return _run(prox_f, prox_g, obj, config, {"ell", "lam"}, data,
                zeros, zeros, zeros, zeros, 1.0, -1.0, mesh=mesh, warm=(x0, z0, u0))


def _prox_f_affine_kkt_batch(x, z, u, rho, d):
    # Fully folded fixed-rho KKT x-prox with a per-lane offset:
    # x = K1 (rho (z - u) - b) + x0 (ops/solve.py:materialize_affine_map).
    return d["K1"] @ (rho * (z - u) - d["b"]) + d["x0"]


def _refuse_dynamic_rho(config, what, fold):
    if config.dynamic_rho:
        raise ValueError(
            f"{what} folds the {fold} at a fixed rho; adaptive/dynamic-rho "
            "configs are not supported (solve lanes serially)")


@highest_precision_setup
def lp_batch(bs, D, Ss, config: ADMMConfig = ADMMConfig(), *, x0=None, z0=None, u0=None,
             mesh=None, device=None, **overrides) -> BatchResults:
    """Solve B standard-form LPs  min b_i^T x  s.t. D x = s_i, x >= 0
    sharing one constraint matrix ``D`` (m, n).  ``bs`` is (n,) shared or
    (B, n), ``Ss`` (m,) shared or (B, m), at least one stacked.  The KKT
    solve is folded once into x = K1 b1 + x0_i: K1 is shared, the offsets
    x0_i = W s_i are one setup GEMM."""
    from ..ops.solve import kkt_eq_solver
    from .linearprogram import _obj, _prox_g

    config = merge_config(config, overrides, body="batched")
    _refuse_dynamic_rho(config, "lp_batch", "KKT solve")
    device = resolve_device(device, D, bs, Ss)
    D = as_tensor(D).to(device)
    m, n = D.shape
    Bn = _lane_count((bs, 1), (Ss, 1))
    bs = _broadcast_lane(bs, Bn, (n,), D.dtype, "bs", device)
    Ss = _broadcast_lane(Ss, Bn, (m,), D.dtype, "Ss", device)
    K1, W = kkt_eq_solver.from_matrices(D, P=None).materialize_affine_map(config.rho)
    data = {"K1": K1, "b": bs, "x0": Ss @ W.T}
    zeros = D.new_zeros((Bn, n))
    return _run(_prox_f_affine_kkt_batch, _prox_g, _obj, config, {"b", "x0"}, data,
                zeros, zeros, zeros, zeros, 1.0, -1.0, mesh=mesh, warm=(x0, z0, u0))


def _prox_f_qp_standard_batch(x, z, u, rho, d):
    # The affine fold of _prox_f_affine_kkt_batch with the QP's linear-cost
    # key (q), so that the objective shares the leaf.
    return d["K1"] @ (rho * (z - u) - d["q"]) + d["x0"]


@dataclasses.dataclass(frozen=True)
class QPStructure:
    """The (P, D, rho)-only pieces of qp_batch's x-update, folded once.

    Receding-horizon callers build this once with ``qp_structure`` and
    pass it to every ``qp_batch`` re-solve: the per-step cost then holds
    no eigh, Cholesky or dense fold, only the per-lane offset GEMM and the
    loop."""

    P: Any
    rho: float
    D: Any = None      # standard form only
    K1: Any = None     # standard fold (ops/solve.py:materialize_affine_map)
    W: Any = None
    Minv: Any = None   # bounded fold

    @property
    def form(self):
        return "bounded" if self.D is None else "standard"


@highest_precision_setup
def qp_structure(P, D=None, rho: float = 1.0, *, device=None) -> QPStructure:
    """Fold the shared QP structure once (see QPStructure).  ``D`` given
    selects the standard (equality + nonnegativity) form, ``D`` omitted
    the bounded (box) form.  ``rho`` must match the config the structure
    is used with."""
    from ..ops.solve import SymShiftSolver, kkt_eq_solver

    device = resolve_device(device, P, D)
    P = as_tensor(P).to(device)
    P = 0.5 * (P + P.T)
    if D is None:
        return QPStructure(P=P, rho=float(rho),
                           Minv=SymShiftSolver.from_matrix(P).materialize_inverse(rho))
    D = _on(D, device, P.dtype)
    K1, W = kkt_eq_solver.from_matrices(D, P=P).materialize_affine_map(rho)
    return QPStructure(P=P, rho=float(rho), D=D, K1=K1, W=W)


@highest_precision_setup
def qp_batch(P, Qs, rs, cons1, cons2, config: ADMMConfig = ADMMConfig(), *,
             form: str = None, structure: QPStructure = None, x0=None, z0=None, u0=None,
             mesh=None, device=None, **overrides) -> BatchResults:
    """Solve B quadratic programs sharing one Hessian ``P`` (n, n) as lanes
    of one solve (the model-predictive-control pattern).

    Forms, detected as the serial wrapper does:

    - standard: ``(cons1, cons2) = (D, Ss)``, D the shared (m, n)
      equality matrix, Ss (m,) or (B, m); one eigh of P and one KKT fold
      shared, the per-lane offsets one setup GEMM;
    - bounded: ``(cons1, cons2) = (lb, ub)``, each (n,) or (B, n).

    A 2-D cons1 selects the standard form, except that a shape-matched
    2-D (cons1, cons2) pair reads as (B, n) lb/ub stacks; for a 2-D lb
    with a shared ub pass ``form='bounded'``.  ``Qs`` is (n,) or (B, n),
    ``rs`` a scalar or (B,).  ``structure=`` (``qp_structure``) reuses a
    fold across re-solves."""
    from ..ops.solve import SymShiftSolver, kkt_eq_solver
    from .quadraticprogram import _obj, _prox_f_bounded_static, _prox_g_bounded
    from .quadraticprogram import _prox_g_standard

    config = merge_config(config, overrides, body="batched")
    _refuse_dynamic_rho(config, "qp_batch", "x-update")
    if form not in (None, "standard", "bounded"):
        raise ValueError(f"form must be 'standard' or 'bounded', got {form!r}")
    device = resolve_device(device, P, Qs, cons1, cons2)
    P = as_tensor(P).to(device)
    P = 0.5 * (P + P.T)
    n = P.shape[0]
    if structure is not None:
        if structure.rho != config.rho:
            raise ValueError(f"structure was folded at rho={structure.rho} but the "
                             f"config uses rho={config.rho}")
        if form is not None and form != structure.form:
            raise ValueError(f"form={form!r} conflicts with the {structure.form!r} structure")
        form = structure.form
    elif form is None:
        s1, s2 = tuple(np.shape(cons1)), tuple(np.shape(cons2))
        if len(s1) != 2:
            form = "bounded"
        elif len(s2) == 2 and s1 == s2 and s1[1] == n:
            # Per-lane (B, n) lb/ub stacks always shape-match each other;
            # an equality matrix D (m, n) shape-matches its RHS stack
            # (B, m) only in the degenerate B == m == n case.
            form = "bounded"
        else:
            form = "standard"

    if form == "standard":
        D = structure.D if structure is not None else _on(cons1, device, P.dtype)
        m = D.shape[0]
        Bn = _lane_count((Qs, 1), (cons2, 1), (rs, 0))
        Qs_ = _broadcast_lane(Qs, Bn, (n,), P.dtype, "Qs", device)
        try:
            Ss = _broadcast_lane(cons2, Bn, (m,), P.dtype, "Ss", device)
        except ValueError as e:
            raise ValueError(
                f"{e} — if cons1/cons2 are per-lane bound stacks rather than an "
                f"equality system, pass form='bounded'") from None
        if structure is not None:
            K1, W = structure.K1, structure.W
        else:
            K1, W = kkt_eq_solver.from_matrices(D, P=P).materialize_affine_map(config.rho)
        data = {"K1": K1, "x0": Ss @ W.T, "q": Qs_}
        prox_f, prox_g, mapped = _prox_f_qp_standard_batch, _prox_g_standard, {"x0", "q", "r"}
    else:
        Bn = _lane_count((Qs, 1), (cons1, 1), (cons2, 1), (rs, 0))
        Qs_ = _broadcast_lane(Qs, Bn, (n,), P.dtype, "Qs", device)
        lb = _broadcast_lane(cons1, Bn, (n,), P.dtype, "lb", device)
        ub = _broadcast_lane(cons2, Bn, (n,), P.dtype, "ub", device)
        lb, ub = torch.minimum(lb, ub), torch.maximum(lb, ub)
        if structure is not None:
            Minv = structure.Minv
        else:
            Minv = SymShiftSolver.from_matrix(P).materialize_inverse(config.rho)
        data = {"Minv": Minv, "q": Qs_, "lb": lb, "ub": ub}
        prox_f, prox_g, mapped = (_prox_f_bounded_static, _prox_g_bounded,
                                  {"q", "lb", "ub", "r"})
    data["P"] = P
    data["r"] = _lanes(rs, Bn, P.dtype, device)
    zeros = P.new_zeros((Bn, n))
    return _run(prox_f, prox_g, _obj, config, mapped, data,
                zeros, zeros, zeros, zeros, 1.0, -1.0, mesh=mesh, warm=(x0, z0, u0))


@highest_precision_setup
def svm_batch(D, ells, C, config: ADMMConfig = ADMMConfig(), *, loss: str = "hinge",
              seed: int = 0, x0=None, z0=None, u0=None, mesh=None, device=None,
              **overrides) -> BatchResults:
    """Train B linear SVMs against one shared design ``D`` (m, n) as lanes
    of one unwrapped-ADMM solve: the one-vs-all pattern (the reference's
    examples/mnistsvm.m:121-156 trains 10 classifiers that differ only in
    their +/-1 labels).  ``ells`` is the (B, m) label stack, ``C`` a
    scalar or (B,).  The pseudo-inverse x-update is shared.  stopcond and
    nodualerror are forced to the unwrapped driver's values and every
    lane starts from ``unwrapped.random_start(seed)``, so lane i is
    ``linearsvm(D, ells[i], C_i, seed=seed)``; x0/z0/u0 override it."""
    from .linearsvm import make_prox_ops
    from .unwrapped import _prox_f, random_start

    # Forced, not defaulted: the serial chain overwrites any caller
    # stopcond/nodualerror with the reference driver's values
    # (unwrappedadmm.m:90-92), so the lanes must too.
    overrides["stopcond"] = "both"
    overrides["nodualerror"] = True
    config = merge_config(config, overrides, body="batched")
    device = resolve_device(device, D, ells)
    D = as_tensor(D).to(device)
    m, n = D.shape
    ells = _check_batch(_on(ells, device, D.dtype), m, "ells")
    Bn = ells.shape[0]
    _, prox_g, obj, data = make_prox_ops(D, ells[0], 1.0, loss, config)
    data = dict(data, ell=ells, C=_lanes(C, Bn, D.dtype, device), Dplus=torch.linalg.pinv(D))
    xr, zr, ur = (v.expand(Bn, -1).contiguous()
                  for v in random_start(seed, n, m, D.dtype, device))
    return _run(_prox_f, prox_g, obj, config, {"ell", "C"}, data,
                xr, zr, ur, D.new_zeros((Bn, m)), D, -1.0, mesh=mesh, warm=(x0, z0, u0))
