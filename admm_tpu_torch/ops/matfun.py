"""Matmul-only matrix functions (port of ``admm_tpu/ops/matfun.py``).

The covariance-selection x-prox is a spectral function of the symmetric
matrix W = rho*(Z - U) - S (reference xminCovarianceSelection,
getProxOps.m:1487-1496):

    X = f(W),   f(e) = (e + sqrt(e^2 + 4 rho)) / (2 rho)
              = (W + sqrt(W^2 + 4 rho I)) / (2 rho)

The reference (and the default path, ``ops/prox.covsel_eig_prox``)
evaluates it by a full eigendecomposition: on the H100 that is cuSOLVER's
``syevd`` (``ops/prox.sym_eigh``: in f64 for an f32 matrix of order up to
512, where torch's own f32 eigh would take the Jacobi ``syevj``), a chain
of small dependent kernels plus a host read of its ``info``.  The same matrix square root is computable with nothing but n^3
matmuls via the coupled Newton-Schulz iteration, which runs on cuBLAS
GEMMs and reads nothing back:

    A = W^2 + 4 rho I   (SPD: every eigenvalue >= 4 rho)
    Y_0 = A / c, Z_0 = I         with  c >= lambda_max(A)
    T_k = (3 I - Z_k Y_k) / 2
    Y_{k+1} = Y_k T_k,  Z_{k+1} = T_k Z_k
    Y_k -> sqrt(A / c),  Z_k -> (A / c)^{-1/2}

The two update products ride one batched GEMM via the exact transpose
identity T Z = (Z^T T^T)^T.  (Do NOT "simplify" to Z T by
commutativity: the iterates commute only in exact arithmetic, and that
rearrangement is numerically unstable — it diverges in f64 by
kappa ~1e4, a classic coupled-Newton-Schulz stability trap.)
Convergence is globally monotone then quadratic; the linear phase
contracts the smallest-eigenvalue error by ~2.25x per step, so the
iteration count needed is ~log(kappa)/log(2.25) + ~5.  kappa(A) <= 1 +
lambda_max(W)^2 / (4 rho) is moderate in practice because rho is the ADMM
step size, not a small regularizer.
"""

from __future__ import annotations

import torch

from ..config import matmul_precision


def _spectral_upper_bound(A):
    """Cheap safe upper bound on lambda_max(A) for symmetric A:
    min(Frobenius norm, max absolute row sum).  Both dominate the
    spectral radius; the min is tight enough that it costs at most
    ~log_2.25(sqrt(n)) extra Newton-Schulz steps."""
    fro = torch.linalg.matrix_norm(A)
    row = torch.amax(torch.sum(torch.abs(A), dim=-1), dim=-1)
    return torch.minimum(fro, row)


def _tr(M):
    return M.transpose(-1, -2)


def ns_sqrtm(A, iters: int = 20, coarse: int = 0, correct: int = 0):
    """sqrt(A) for symmetric positive-definite A via coupled
    Newton-Schulz — matmuls only, no factorization, no host read.

    Takes leading batch dimensions.  ``iters`` steps of 2 GEMMs + 1
    batched GEMM each.  Use iters ~ log(kappa(A))/log(2.25) + 5; the
    default 20 covers kappa up to ~1e7 at f64 machine precision.

    ``coarse``: run the first ``coarse`` iterations under
    ``config.matmul_precision('default')`` — torch's 'medium', which lets
    cuBLAS take float32 matmuls through the H100's tensor cores at reduced
    precision — and the remaining ones at the ambient precision (full f32
    in a solve).  It changes float32 matmuls on the card only: float64,
    and the CPU's float64 tests, see no difference.  Coarse noise drifts
    the coupled (Y, Z) pair off its invariant manifold in directions the
    iteration does not contract, so trailing full-precision steps do not
    remove it; ``correct`` does.

    ``correct``: after the iteration, apply that many residual
    corrections at the ambient precision — the first-order Sylvester
    update dS S + S dS = A - S^2 approximated via the computed inverse
    root, S += 0.5 (A - S^2) Z/sqrt(c), ~3 matmuls each.  Unlike trailing
    NS steps this contracts the actual residual regardless of the drift.
    The fast covsel recipe is coarse=iters, correct=2.
    """
    n = A.shape[-1]
    I = torch.eye(n, dtype=A.dtype, device=A.device)
    c = _spectral_upper_bound(A)[..., None, None]
    Y = A / c
    Z = I.expand(A.shape)

    def step(Y, Z):
        T = 1.5 * I - 0.5 * (Z @ Y)
        # Stable coupled update Y <- Y T, Z <- T Z, with T Z computed as
        # (Z^T T^T)^T so both products form one batched GEMM.
        P = torch.stack([Y, _tr(Z)]) @ torch.stack([T, _tr(T)])
        return P[0], _tr(P[1])

    coarse = min(int(coarse), int(iters))
    if coarse:
        with matmul_precision("default"):
            for _ in range(coarse):
                Y, Z = step(Y, Z)
    for _ in range(iters - coarse):
        Y, Z = step(Y, Z)
    S = torch.sqrt(c) * Y
    S = 0.5 * (S + _tr(S))
    if correct:
        Zs = Z / torch.sqrt(c)  # ~ S^{-1} from the coupled iteration
        for _ in range(int(correct)):
            E = A - S @ S
            S = S + 0.5 * (E @ Zs)
            S = 0.5 * (S + _tr(S))
    return S


def covsel_ns_prox(W, rho, iters: int = 20, coarse: int = 0,
                   correct: int = 0, weight=1.0):
    """Covariance-selection x-prox via Newton-Schulz square root.

    The same spectral function as ``ops/prox.covsel_eig_prox``
    (reference getProxOps.m:1487-1496) evaluated as
    (W + sqrt(W^2 + 4 rho w I)) / (2 rho) with ``ns_sqrtm`` — GEMMs only,
    no eigendecomposition and no host read inside the ADMM loop.
    ``coarse`` (see ``ns_sqrtm``) runs that many leading square-root
    steps at reduced matmul precision; the W^2 forming A stays at the
    ambient full precision (a coarse A would bound the result's accuracy
    no matter how the iteration refines).  ``correct`` residual
    corrections at full precision recover what the coarse phase loses.

    ``weight`` (w above, default 1) is the logdet coefficient — the
    consensus covsel split's per-shard prox of tr(S_i X) - w logdet X.
    The square-root argument stays bounded below by 4 rho w > 0, so the
    NS iteration keeps its conditioning guarantee
    (kappa <= 1 + lambda_max(W)^2/(4 rho w)).
    """
    n = W.shape[-1]
    I = torch.eye(n, dtype=W.dtype, device=W.device)
    A = W @ W + ((4.0 * weight) * rho) * I
    return (W + ns_sqrtm(A, iters, coarse, correct)) / (2.0 * rho)


def psd_project_ns(W, iters: int = 24, coarse: int = 0, correct: int = 0,
                   delta: float = 0.0):
    """PSD-cone projection via Newton-Schulz — matmuls only, no eigh.

    Evaluates max(W, 0) spectrally as (W + |W|) / 2 with
    |W| = sqrt(W^2 + delta^2 I) (``ns_sqrtm``).  The SDP z-prox's
    performance mode (``models/sdp.py``), the same swap covsel makes with
    ``covsel_ns_prox``.

    Conditioning caveat (unlike covsel): covsel's square-root argument is
    bounded below by 4 rho, but a projection argument can have eigenvalues
    arbitrarily close to zero, where the NS square root converges slowly.
    The absolute spectral error on a mode of magnitude |lambda| is bounded
    by ~|lambda| (NS underestimates small roots toward 0), so near-null
    modes contribute small absolute error; set ``delta`` > 0 to regularize
    the root at an O(delta) accuracy floor, or raise ``iters``.  Use the
    exact eigh path (``ops/prox.psd_project``) when the active spectrum
    crosses zero slowly.

    ``correct`` > 0 with ``delta`` = 0 diverges: the residual correction
    applies the coupled inverse root Z ~ S^{-1}, which blows up on the
    near-singular W^2 (``models/sdp.make_prox_ops`` refuses it).
    """
    Ws = 0.5 * (W + _tr(W))
    n = Ws.shape[-1]
    A = Ws @ Ws
    if delta:
        A = A + (delta * delta) * torch.eye(n, dtype=Ws.dtype, device=Ws.device)
    return 0.5 * (Ws + ns_sqrtm(A, iters, coarse, correct))
