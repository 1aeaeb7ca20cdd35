"""The dense fat LASSO of Boyd et al.'s ``lasso_example.m``.

Instances: D (m x n) with N(0, 1) entries and unit columns, a planted x0
with a share ``density`` of N(0, 1) entries, s = D x0 + sqrt(noise_var)
N(0, 1); lam = lambda_factor * ||D^T s||_inf.  A pool of them is drawn on the
card at set-up, in float32, in a few large calls, from the configuration's
``base_seed``; the run's seed then permutes each instance's rows and
columns and flips the signs of its columns.  That gives each seed other
inputs of the same problems (the solution is permuted and sign-flipped
alike), so every seed gets the same work in another order.

Traffic ``kind``: ``solve`` calls ``admm_tpu_torch.lasso`` on one
instance a request at the configuration's lambda; ``path`` calls
``admm_tpu_torch.lasso_path`` on one instance with ``nlambda`` values
log-spaced from lambda_max down to ``lambda_min_ratio`` lambda_max.
"""

from __future__ import annotations

import math

import torch

from benchlib import roofline
from families.common import Outcome, Spec, admm_config, rounds
from reference.lasso import admm_lasso


class Pool:
    def __init__(self, D, s, lam_max, paths, device):
        self.D, self.s, self.lam_max, self.paths, self.device = D, s, lam_max, paths, device


def make_pool(config, traffic, seed, device):
    P, m, n = traffic["pool"], config["m"], config["n"]
    dt = getattr(torch, config["dtype"])
    g = torch.Generator(device=device)
    g.manual_seed(config["base_seed"])
    x0 = torch.randn((P, n), generator=g, device=device, dtype=dt)
    x0 *= torch.rand((P, n), generator=g, device=device, dtype=dt) < config["density"]
    D = torch.randn((P, m, n), generator=g, device=device, dtype=dt)
    D /= torch.linalg.vector_norm(D, dim=1, keepdim=True)
    noise = torch.randn((P, m), generator=g, device=device, dtype=dt)
    s = torch.bmm(D, x0[..., None])[..., 0] + math.sqrt(config["noise_var"]) * noise
    del x0, noise
    g.manual_seed(seed)
    for i in range(P):
        rows = torch.randperm(m, generator=g, device=device)
        cols = torch.randperm(n, generator=g, device=device)
        signs = torch.randint(0, 2, (n,), generator=g, device=device, dtype=dt) * 2 - 1
        D[i] = D[i][rows][:, cols] * signs
        s[i] = s[i][rows]
    lam_max = torch.bmm(D.transpose(1, 2), s[..., None])[..., 0].abs().amax(dim=1)
    paths = None
    if traffic["kind"] == "path":
        L = traffic["nlambda"]
        grid = traffic["lambda_min_ratio"] ** (torch.arange(L, device=device, dtype=dt) / (L - 1))
        paths = lam_max[:, None] * grid[None, :]
    return Pool(D, s, lam_max.tolist(), paths, device)


def requests(config, traffic, seed, pool):
    """The seed's endless request stream."""
    for i, entry in enumerate(rounds(seed, traffic["pool"])):
        if traffic["kind"] == "solve":
            yield Spec(i, entry, config["lambda_factor"] * pool.lam_max[entry])
        else:
            yield Spec(i, entry, pool.paths[entry])


def port(config, traffic, **changes):
    """The port's entry for this traffic: ``call(pool, spec) -> Outcome``."""
    from admm_tpu_torch import lasso, lasso_path

    cfg = admm_config(config, **changes)
    opts = config.get("entry", {}).get(traffic["kind"], {})
    if traffic["kind"] == "solve":
        def call(pool, spec):
            res = lasso(pool.D[spec.entry], pool.s[spec.entry], spec.lam, cfg,
                        device=pool.device, **opts)
            return Outcome(res.xopt[None], res.zopt[None], res.uopt[None], [res.steps],
                           res.runtime, bool(res.diverged))
    else:
        def call(pool, spec):
            res = lasso_path(pool.D[spec.entry], pool.s[spec.entry], spec.lam, cfg,
                             device=pool.device, **opts)
            return Outcome(res.xopt, res.zopt, res.uopt, res.steps, res.runtime)
    return call


def reference(config, pool, spec, stop_at=None, precision="float64"):
    """The plain reference on the request's inputs: (x, z, u, own steps)."""
    lams = torch.as_tensor(spec.lam, device=pool.device).reshape(-1)
    return admm_lasso(pool.D[spec.entry], pool.s[spec.entry], lams, rho=config["rho"],
                      abstol=config["abstol"], reltol=config["reltol"],
                      maxiters=config["maxiters"], stop_at=stop_at, precision=precision)


def controls(config, traffic):
    """The controls, each in the port's place: the reference computed
    with TF32 products, and the port's own TF32 path (its loop under
    ``matmul_precision='high'``)."""

    def reference_tf32(pool, spec):
        x, z, u, steps = reference(config, pool, spec, precision="tf32")
        return Outcome(x, z, u, steps, 0.0)

    return {"reference_tf32": reference_tf32,
            "port_tf32": port(config, traffic, matmul_precision="high")}


def layer_cost(layer, config, lanes):
    """The least-time work of ``layer`` for one step of ``lanes``
    instances (None for a layer this family does not have)."""
    m, n = config["m"], config["n"]
    costs = {"xupdate": lambda: roofline.fat_lasso_xupdate(m, n, lanes),
             "k1b": lambda: roofline.soft_threshold_tail(n, lanes),
             "step": lambda: roofline.lasso_step(m, n, lanes),
             "once": lambda: roofline.gemv(m, n, lanes)}
    return costs[layer]() if layer in costs else None


def working_set(config):
    """Bytes a step streams, against the card's L2."""
    m, n = config["m"], config["n"]
    least = roofline.fat_lasso_xupdate(m, n).bytes
    return (f"working set: the port's x-update streams D and E (m x n each), "
            f"{8 * m * n / 1e6:.1f} MB a step, past the {roofline.L2_BYTES / 2**20:.0f} MiB L2; "
            f"the x-update's least inputs, D and a triangular m x m factor, are "
            f"{least / 1e6:.1f} MB, read once a step from HBM in its roofline")


def counters():
    """The port's launch counters, keyed by a part of the kernel's name."""
    from admm_tpu_torch.ops import gemv_pair, kernels

    return {"zu_tail": kernels.fused_zu_tail.launches,
            "gemv_pair": gemv_pair.gemv_pair.launches}
