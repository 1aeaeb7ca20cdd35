"""Sharded standard-form SDP: the transpose-reduction pattern at
matrix-iterate scale (port of ``admm_tpu/parallel/sdp.py``).

    min <C, X>   s.t.   A(X) = b,  X PSD

with the m dense constraint matrices A_i — the memory- and FLOP-dominant
operand, m x n^2 floats — in W stacked shards of m/W (``models/sdp.py``
is the serial twin).  Per x-prox (the affine projection onto A(X) = b):

    r_i  = A_i(V) - b_i            per-shard contraction
    r    = concat_i r_i            the m residuals
    y    = G^{-1} r                (m, m) Cholesky solve
    corr = sum_i A_i^T y_i         per-shard contraction, summed over shards

The (n, n) iterates X/Z/U are the core engine's (``engine.admm``), so
every engine variant runs sharded; the z-prox is the serial PSD
projection (eigh or Newton-Schulz).  m is zero-padded up to a multiple of
W: a padded constraint carries 1.0 on the Gram's diagonal, so G stays
SPD, and its residual and multiplier are 0.

Over a mesh with a process group each rank keeps its block of the
constraint stack; an x-prox then issues one ``all_gather`` of the m
residuals and one ``all_reduce`` of the n^2-float correction (the m + n^2
floats per iteration of ``admm_tpu``'s docstring).  Every rank forms the
(m, m) Gram factor from the whole stack it is handed, as every process
of ``admm_tpu`` holds the whole host array it places, so the factor is
the same bits on every rank; the engine's (n, n) iterates are whole on
every rank.
"""

from __future__ import annotations

from typing import Optional

import torch

from ..config import ADMMConfig, matmul_precision
from ..engine import Hooks, admm
from ..models._common import as_tensor, merge_config
from ..models.sdp import _ns_prox_g, _obj, _prox_g, _sym, check_gram_conditioning
from ..ops.solve import cho_factor, cho_solve
from ..results import ADMMResults
from .mesh import Mesh, resolve_mesh, shard_count


def _make_prox_f(mesh):
    """The affine projection with the constraint stack (W, mw, n, n), this
    rank's block of it in ``d["A"]`` when ``mesh`` has a process group;
    ``mesh=None``: the whole stack, no mesh."""
    same = lambda t: t  # noqa: E731
    gather, psum, take = (same, same, same) if mesh is None else (mesh.gather, mesh.psum,
                                                                  mesh.take)

    def prox(X, Z, U, rho, d):
        V = Z - U - d["C"] / rho
        ri = gather(torch.einsum("wkij,ij->wk", d["A"], V))
        y = cho_solve((d["L"], True), ri.reshape(-1) - d["bpad"])
        return V - psum(torch.einsum("wk,wkij->ij", take(y.reshape(ri.shape)), d["A"]))

    return prox


_prox_f_sharded = _make_prox_f(None)


def gram_factor(A4, pad_diag):
    """The lower Cholesky factor of G = A A^T + diag(pad_diag) over the
    flattened stack, at full precision."""
    with matmul_precision("highest"):
        W, mw, n, _ = A4.shape
        Af = A4.reshape(W * mw, n * n)
        return cho_factor(Af @ Af.T + torch.diag(pad_diag), lower=True)[0]


def sdp_sharded(
    C,
    A,
    b,
    config: ADMMConfig = ADMMConfig(),
    *,
    mesh: Optional[Mesh] = None,
    nshards: Optional[int] = None,
    prox_method: str = "eigh",
    ns_iters: int = 24,
    ns_coarse: int = 0,
    ns_correct: int = 0,
    ns_delta: float = 0.0,
    x0=None,
    z0=None,
    u0=None,
    device=None,
    **overrides,
) -> ADMMResults:
    """Standard-form SDP with the (m, n, n) constraint stack in W shards —
    the algebra of ``models.sdp.sdp`` on dense constraints.
    ``prox_method``/``ns_*`` select the PSD projection as in the serial
    wrapper.  ``nshards`` defaults to the mesh size; m is zero-padded up to
    a shard multiple (padded constraints are exact no-ops).  The solve
    runs in C's dtype on ``device``, the mesh's device, C's, or the CUDA
    device.
    """
    if prox_method not in ("eigh", "ns"):
        raise ValueError(f"prox_method must be 'eigh' or 'ns', got {prox_method!r}")
    if prox_method == "ns" and int(ns_correct) > 0 and float(ns_delta) == 0.0:
        raise ValueError("prox_method='ns' with ns_correct > 0 requires ns_delta > 0 "
                         "(models/sdp.py setup rule)")
    if isinstance(A, str):
        raise ValueError("sdp_sharded shards a dense (m, n, n) constraint stack; the 'diag' "
                         "constraint is O(n) per iteration — use models.sdp.sdp")
    config = merge_config(config, overrides, body="heavy")
    mesh, device = resolve_mesh(mesh, device, C, A, b)
    W, mesh = shard_count(mesh, nshards)

    C = _sym(as_tensor(C).to(device))
    n = C.shape[-1]
    if tuple(C.shape) != (n, n):
        raise ValueError(f"C must be square, got {tuple(C.shape)}")
    A = as_tensor(A).to(device=device, dtype=C.dtype)
    if A.ndim != 3 or tuple(A.shape[1:]) != (n, n):
        raise ValueError(f"A must be (m, {n}, {n}), got {tuple(A.shape)}")
    A = _sym(A)
    m = A.shape[0]
    b = torch.atleast_1d(as_tensor(b).to(device=device, dtype=C.dtype))
    if tuple(b.shape) != (m,):
        raise ValueError(f"b must have shape {(m,)}, got {tuple(b.shape)}")

    mw = -(-m // W)
    m_pad = mw * W
    A4 = torch.cat((A, A.new_zeros((m_pad - m, n, n)))).reshape(W, mw, n, n)
    bpad = torch.cat((b, b.new_zeros(m_pad - m)))
    pad_diag = torch.cat((b.new_zeros(m), b.new_ones(m_pad - m)))
    L = gram_factor(A4, pad_diag)
    check_gram_conditioning(L)  # one host read of the pivots, at setup
    data = {"C": C, "A": mesh.take(A4), "bpad": bpad, "L": L}
    pg = (_prox_g if prox_method == "eigh"
          else _ns_prox_g(int(ns_iters), int(ns_coarse), int(ns_correct), float(ns_delta)))
    zero = torch.zeros((n, n), dtype=C.dtype, device=device)
    res = admm(_make_prox_f(mesh), pg, config, A=1.0, B=-1.0, c=0.0, shape_x=(n, n),
               shape_z=(n, n), x0=zero if x0 is None else x0, z0=zero if z0 is None else z0,
               u0=zero if u0 is None else u0, hooks=Hooks(obj=_obj), dtype=C.dtype, data=data,
               device=device)
    res.extra.update(nshards=W, mesh=mesh)
    return res
