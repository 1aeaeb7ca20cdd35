"""Gradient-based hyperparameter tuning through the ADMM solver (port of
``examples/hypergradient.py``).

The denoising strength ``lam`` of a 1-D total-variation denoiser is
LEARNED by descending

    d MSE(x*(lam), ground truth) / d lam,

the hypergradient through the ADMM fixed point
(``admm_tpu_torch.make_implicit_solver``), in a handful of Adam steps.

``solver='dense'`` is the reference example: the x-prox applies a dense
(I + rho D^T D)^-1 carried in ``data``.  ``solver='cr'`` takes the TV
proxes of ``models/totalvariation.make_prox_ops`` instead: the x-prox is
the cyclic-reduction solve, on the card the CUDA kernel K4, which then
runs in the forward solve, in every adjoint step and in the
linearizations at the fixed point.  ``consensus_hypergradient`` learns
the lasso strength of a consensus solve over sharded rows, through
``make_implicit_consensus_solver``: stacked on one device, or over the
ranks of a process group (``parallel.global_mesh``), where the backward's
means cross the ranks as the forward's do.

Usage:  python -m admm_tpu_torch.examples.hypergradient [--device cpu] [--solver cr]
"""

from __future__ import annotations

import argparse

import numpy as np
import torch


def tv_prox_f(xhat, z, u, rho, data):
    # argmin 0.5||x - b||^2 + rho/2 ||Dx - (z - u)||^2 with Ginv =
    # (I + rho D^T D)^-1 precomputed once and carried in data.
    return data["Ginv"] @ (data["b"] + rho * (data["D"].T @ (z - u)))


def tv_prox_g(xhat, z, u, rho, data):
    v = data["D"] @ xhat + u
    k = torch.exp(data["loglam"]) / rho  # positive lam via log-parameterization
    return torch.sign(v) * torch.clamp_min(torch.abs(v) - k, 0.0)


def make_truth(n, noise, seed):
    """The piecewise-constant ground truth and its noisy copy, as numpy
    arrays (the reference example's construction and draws)."""
    rng = np.random.default_rng(seed)
    truth = np.zeros(n)
    for lo, hi, v in [(0, 60, 1.0), (60, 120, -0.5), (120, 200, 2.0)]:
        truth[lo:hi] = v
    return truth, truth + noise * rng.standard_normal(n)


def hypergradient_tuning(n=200, noise=0.25, steps=25, lr=0.3, seed=0, quiet=False,
                         device=None, solver="dense", dtype=torch.float64):
    """Learn lam by Adam on the hypergradient; returns the history of
    (lam, MSE) per step.  Runs on ``device`` (the card unless the caller
    asks for the CPU, ``device.resolve_device``) in ``dtype``."""
    from admm_tpu_torch import ADMMConfig, make_implicit_solver
    from admm_tpu_torch.device import resolve_device
    from admm_tpu_torch.linop import DiffOp

    dev = resolve_device(device)
    truth_np, b_np = make_truth(n, noise, seed)
    truth = torch.as_tensor(truth_np, dtype=dtype, device=dev)
    b = torch.as_tensor(b_np, dtype=dtype, device=dev)
    A_op = DiffOp(n)  # (Dx)_i = x_i - x_{i+1}, last row identity
    cfg = ADMMConfig(rho=1.0, maxiters=2000, abstol=1e-10, reltol=1e-10, quiet=True)
    # Constraint Dx - z = 0: A is the difference operator, c = 0.
    if solver == "dense":
        D = A_op.dense(dtype, dev)
        Ginv = torch.linalg.inv(torch.eye(n, dtype=dtype, device=dev) + cfg.rho * (D.T @ D))
        solve = make_implicit_solver(tv_prox_f, tv_prox_g, cfg, A=A_op, nA=n, nB=n)
        make_data = lambda ll: {"D": D, "b": b, "Ginv": Ginv, "loglam": ll}  # noqa: E731
    elif solver == "cr":
        from admm_tpu_torch.models.totalvariation import make_prox_ops

        prox_f, prox_g, _obj, data, _D = make_prox_ops(b, 1.0, cfg, solver="cr")
        solve = make_implicit_solver(prox_f, prox_g, cfg, A=A_op, nA=n, nB=n)
        make_data = lambda ll: dict(data, lam=torch.exp(ll))  # noqa: E731
    else:
        raise ValueError(f"unknown solver {solver!r} (want 'dense' or 'cr')")

    def mse(ll):
        x, _, _ = solve(make_data(ll))
        return torch.mean((x - truth) ** 2)

    loglam = torch.tensor(float(np.log(0.01)), dtype=dtype, device=dev)  # a poor start
    # Adam on the hypergradient (inlined: one scalar parameter).
    b1, b2, eps = 0.9, 0.999, 1e-8
    mt = vt = torch.zeros_like(loglam)
    history = []
    for k in range(steps):
        g, val = torch.func.grad_and_value(mse)(loglam)
        history.append((float(torch.exp(loglam)), float(val)))
        if not quiet:
            print(f"step {k:2d}: lam = {float(torch.exp(loglam)):.4f}  "
                  f"MSE = {float(val):.5f}  dMSE/dloglam = {float(g):+.5f}")
        mt = b1 * mt + (1 - b1) * g
        vt = b2 * vt + (1 - b2) * g * g
        mhat = mt / (1 - b1 ** (k + 1))
        vhat = vt / (1 - b2 ** (k + 1))
        loglam = loglam - lr * mhat / (torch.sqrt(vhat) + eps)

    final_lam, final_mse = history[-1]
    noisy_mse = float(torch.mean((b - truth) ** 2))
    if not quiet:
        print(f"\nlearned lam = {final_lam:.4f}: MSE {final_mse:.5f} "
              f"(noisy input MSE {noisy_mse:.5f}, start MSE {history[0][1]:.5f})")
    return history


def consensus_hypergradient(m=512, n=24, steps=12, lr=0.4, seed=0, quiet=False, *,
                            nshards=None, mesh=None, device=None, dtype=torch.float64):
    """Learn the lasso strength ``lam`` of a CONSENSUS solve, its training
    rows in ``nshards`` shards (default: the mesh size, ``make_mesh(8)``
    without a mesh), by descending a held-out MSE through the sharded
    fixed point (``make_implicit_consensus_solver``) with ``admm_tpu``'s
    clipped sign steps.  Returns the history of (lam, validation MSE)."""
    from admm_tpu_torch import ADMMConfig, make_implicit_consensus_solver
    from admm_tpu_torch.device import resolve_device
    from admm_tpu_torch.parallel.consensus import (_lasso_global_prox, _lasso_local_prox,
                                                   ls_setup)
    from admm_tpu_torch.parallel.mesh import make_mesh, pad_rows, shard_rows

    rng = np.random.default_rng(seed)
    xtrue = rng.standard_normal(n) * (rng.random(n) < 0.4)
    D = rng.standard_normal((m, n))
    s = D @ xtrue + 0.1 * rng.standard_normal(m)
    Dval = rng.standard_normal((m // 4, n))
    sval = Dval @ xtrue + 0.1 * rng.standard_normal(m // 4)

    dev = mesh.device if mesh is not None else resolve_device(device)
    W = int(nshards) if nshards is not None else (mesh.size if mesh is not None else 8)
    cfg = ADMMConfig(rho=1.0, maxiters=4000, abstol=1e-11, reltol=1e-11, quiet=True)
    t = lambda a: torch.as_tensor(a, dtype=dtype, device=dev)  # noqa: E731
    take = mesh.take if mesh is not None else (lambda a: a)  # noqa: E731
    setup = ls_setup(take(shard_rows(pad_rows(t(D), W)[0], W)),
                     take(shard_rows(pad_rows(t(s), W)[0], W)), False, cfg.rho)
    Dval, sval = t(Dval), t(sval)
    solve = make_implicit_consensus_solver(_lasso_local_prox, _lasso_global_prox, cfg, n, W,
                                           mesh=mesh if mesh is not None
                                           else make_mesh(W, device=dev))

    def val_mse(ll):
        _, z, _ = solve(dict(setup, lam=torch.exp(ll)))
        return torch.mean((Dval @ z - sval) ** 2)

    loglam = t(float(np.log(50.0)))  # deliberately over-shrunk
    history = []
    for k in range(steps):
        g, val = torch.func.grad_and_value(val_mse)(loglam)
        history.append((float(torch.exp(loglam)), float(val)))
        if not quiet:
            print(f"step {k:2d}: lam = {float(torch.exp(loglam)):8.4f}  "
                  f"val MSE = {float(val):.5f}  grad = {float(g):+.5f}")
        loglam = loglam - lr * torch.sign(g) * torch.clamp_max(torch.abs(g) * 10, 1.0)

    if not quiet:
        print(f"\nlearned lam = {history[-1][0]:.4f}: "
              f"val MSE {history[-1][1]:.5f} (start {history[0][1]:.5f})")
    return history


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None)
    ap.add_argument("--solver", default="dense", choices=("dense", "cr"))
    ap.add_argument("--n", type=int, default=200)
    ap.add_argument("--steps", type=int, default=25)
    ap.add_argument("--consensus", action="store_true",
                    help="run consensus_hypergradient (8 stacked shards) after the tuning")
    args = ap.parse_args(argv)
    hypergradient_tuning(n=args.n, steps=args.steps, device=args.device, solver=args.solver)
    if args.consensus:
        consensus_hypergradient(device=args.device)


if __name__ == "__main__":
    main()
